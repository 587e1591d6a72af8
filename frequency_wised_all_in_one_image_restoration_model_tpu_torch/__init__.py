"""Frequency-wised All-in-One Image Restoration — PyTorch / CUDA port.

The PyTorch counterpart of ``frequency_wised_all_in_one_image_restoration_model_tpu``
(the JAX package, which stays the reference). Module paths, class names and
public layouts mirror the JAX package: images ``[B, H, W, C]``, tokens
``[B, N, C]``, per-head weights ``[h, C, d]``. The LeWin-block Pallas kernels
become hand-written CUDA kernels for Hopper (``csrc/``), each with a plain
PyTorch twin that runs on the CPU.

This package imports ``torch`` and never ``jax``, nor anything of the JAX
package: it keeps its own copy of what it needs from the JAX package's
numpy-only modules (``config``, ``data``, ``utils``).

Modules
-------
test          the eval CLI: ``python -m <this package>.test <flags>``
config        the configuration and command line (the JAX package's flags)
data          test sets: file-backed, synthetic; image decoding
ops           frequency decomposition, window machinery, metrics, CUDA kernel wrappers
models        Uformer encoder/decoder, LeWin blocks, AirNet eval composition
evaluation    tiled full-image restoration, the per-task runner
training      eval checkpoints (``epoch_<N>.pt``)
utils         JAX-parameter -> state_dict conversion, image I/O, the results log
"""

from . import config  # noqa: F401
