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
train         the training CLI: ``python -m <this package>.train <flags>``
serving       the eval forward exported as a ``.fairm`` artifact (one
              ``torch.export`` program, the forward kernels as custom ops);
              its CLI ``python -m <this package>.export_serving <flags>``
config        the configuration and command line (the JAX package's flags)
data          train loaders and test sets: file-backed, synthetic; image decoding
ops           frequency decomposition, window machinery, metrics, CUDA kernel
              wrappers (forward and backward), their autograd Functions and
              custom ops; image utilities (resize, NIQE, edges, patches)
models        Uformer encoder/decoder, LeWin blocks, AirNet composition, MoCo
evaluation    tiled full-image restoration, the per-task runner
training      losses, train state, the two-phase steps, the loop, checkpoints
              (``epoch_<N>.pt``: the models, and the whole train state)
utils         JAX-parameter / train-state conversion, image I/O, run logs,
              the step meter, plots
analysis      the analysis toolkit: results logs, frequency histograms,
              embeddings and lamb gains, attention-map band energy, LFS
              channel scores
scripts       its CLIs, one per root ``plot_*.py`` and the sweep runner:
              ``python -m <this package>.scripts.<name> <flags>``

Importing the package imports none of its modules: a process that loads a
served artifact imports ``serving`` and the kernels' registrations only.
"""
