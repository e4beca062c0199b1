from nerrf_tpu_torch.schema.events import (
    EventArrays,
    InodeTable,
    OpenFlags,
    StringTable,
    Syscall,
)

__all__ = ["EventArrays", "InodeTable", "OpenFlags", "StringTable", "Syscall"]
