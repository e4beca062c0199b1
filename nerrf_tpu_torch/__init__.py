"""nerrf_tpu_torch: NERRF detection in PyTorch, with hand-written CUDA kernels
for an NVIDIA H100 (``sm_90a``).

The port of the JAX package ``nerrf_tpu``, which stays the reference.  Module
names and layout mirror it, so each module's counterpart is found by name;
the port imports nothing of it.  Entry points run on ``cuda`` unless the
caller passes ``device="cpu"``; without a card they raise rather than fall
back.
"""

from nerrf_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
