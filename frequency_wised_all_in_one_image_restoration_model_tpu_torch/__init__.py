"""Frequency-wised All-in-One Image Restoration — PyTorch / CUDA port.

The PyTorch counterpart of ``frequency_wised_all_in_one_image_restoration_model_tpu``
(the JAX package, which stays the reference). Module paths, class names and
public layouts mirror the JAX package: images ``[B, H, W, C]``, tokens
``[B, N, C]``, per-head weights ``[h, C, d]``. The LeWin-block Pallas kernels
become hand-written CUDA kernels for Hopper (``csrc/``), each with a plain
PyTorch twin that runs on the CPU.

This package imports ``torch`` and never ``jax``, nor anything of the JAX
package: ``config`` holds its own copy of the configuration fields the port
reads.

Modules
-------
config        the slice's configuration fields (names and defaults of the JAX ones)
ops           frequency decomposition, window machinery, CUDA kernel wrappers
models        Uformer encoder/decoder, LeWin blocks, AirNet eval composition
utils         JAX-parameter -> state_dict conversion
evaluation    tiled full-image restoration
"""

from . import config  # noqa: F401
