"""Serving export of the port: the eval forward as one ``torch.export``
program in a self-contained ``.fairm`` artifact with its weights (the
counterpart of the JAX package's ``serving.py``).

The program is the eval composition of ``models/airnet.py::eval_forward``,
the encoder's conditioning then the decoder, on a fixed batch of
``crop_test_imgs_size`` tiles. A process that loads the artifact needs
torch, this module and the kernels' registrations
(``ops/kernels/custom_ops.py``): no model code, no configuration, no
checkpoint.

* On the card every forward kernel of the route an eager call of that
  batch takes is one ``fairm::`` node of the program (the ops launch the
  CUDA kernels of ``csrc/``, built at the first launch). The kernels read
  their weights in their own formats: a second program, run once at load
  time, makes those operands from the weights, and the forward program
  takes them as inputs beside the weights, as an eager model holds them
  (``models/uformer_blocks.py::KernelParams``).
* On the CPU (``device="cpu"``) the program is the plain route, the
  kernels' plain twins, and has no second program.
* The weights are call arguments, never constants of the program: the
  artifact stores them once, as an ``.npz``, and the programs are saved
  without their example inputs.

Artifact layout (one file): a 16-byte header (magic, version, metadata
length), JSON metadata, the ``.npz`` of the weights, then the
``torch.export.save`` bytes of the forward program and of the operands'
program. The magic differs from the JAX package's, so each package's
:func:`loads` refuses the other's artifact. A CUDA artifact runs on the
card only, against the kernel sources it was exported with.

Use :func:`export_eval` and :func:`load`, or the CLI
``python -m <this package>.export_serving``.
"""

from __future__ import annotations

import dataclasses
import io
import json
import struct
from typing import List, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from .ops.kernels import build, custom_ops

MAGIC = b"FAIRMTRC"
VERSION = 1


def resolve_device(device) -> torch.device:
    """``device``, or the current CUDA device for None (it raises without
    one)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: a served program runs the port's kernels on "
                "an NVIDIA GPU; pass device='cpu' for the plain PyTorch path")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)


class _EvalForward(nn.Module):
    """The eval forward ``decoder(x, encoder.features(x))``; ``operands``,
    the kernels' operands of ``holders`` in order, flattened, are handed to
    the holders for the call (``KernelParams.served_operands``)."""

    def __init__(self, encoder, decoder, holders=(), templates=()):
        super().__init__()
        self.encoder, self.decoder = encoder, decoder
        # the holders (not registered twice) and one made set of operands
        # of each, for the structure the flat inputs are refilled into
        self.holders, self.templates = list(holders), list(templates)

    def forward(self, x, operands: Sequence[torch.Tensor] = ()):
        flat = iter(operands)
        for h, t in zip(self.holders, self.templates):
            h.served_operands = type(t)(*(next(flat) if torch.is_tensor(v)
                                          else v for v in t))
        try:
            return self.decoder(x, self.encoder.features(x))
        finally:
            for h in self.holders:
                h.served_operands = None


class _KernelOperands(nn.Module):
    """The kernels' operands of ``holders`` (``make_operands`` of their
    weights in ``dtype``), flattened in order."""

    def __init__(self, encoder, decoder, holders, dtype):
        super().__init__()
        self.encoder, self.decoder = encoder, decoder
        self.holders, self.dtype = list(holders), dtype

    def forward(self):
        return [v for h in self.holders
                for v in h.make_operands(*h.kernel_weights(), self.dtype)
                if torch.is_tensor(v)]


class _Program(nn.Module):
    """What a served program is traced from: ``module`` called with its
    parameters and buffers taken from ``weights`` (``names`` in order). The
    module is held unregistered, so that the program's state is its
    inputs."""

    def __init__(self, module, names):
        super().__init__()
        object.__setattr__(self, "inner", module)
        self.names = list(names)

    def forward(self, weights: List[torch.Tensor], *args):
        return torch.func.functional_call(
            self.inner, dict(zip(self.names, weights)), args)


def _program_bytes(ep) -> bytes:
    ep.example_inputs = None   # the weights are stored once, in the .npz
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    return buf.getvalue()


def export_eval(cfg, variables, batch: int = 8, device=None) -> bytes:
    """Export the eval forward with ``variables = (enc_state, dec_state)``,
    the two models' state dicts in the port's names (``utils/weights.py::
    from_jax`` makes them from the JAX trees). Returns the artifact's
    bytes. ``device=None`` is the card (it raises without one);
    ``device="cpu"`` exports the plain route."""
    from .models.airnet import build_models, model_dtype
    from .models.uformer_blocks import KernelParams

    device = resolve_device(device)
    enc_state, dec_state = variables
    bundle = build_models(cfg, device)
    bundle.encoder.load_state_dict(enc_state, strict=True)
    bundle.decoder.load_state_dict(dec_state, strict=True)
    enc_paths, dec_paths = list(enc_state), list(dec_state)
    names = ([f"encoder.{k}" for k in enc_paths]
             + [f"decoder.{k}" for k in dec_paths])
    state = {f"encoder.{k}": v for k, v in bundle.encoder.state_dict().items()}
    state.update((f"decoder.{k}", v)
                 for k, v in bundle.decoder.state_dict().items())
    weights = [state[k] for k in names]
    p = cfg.crop_test_imgs_size
    x = torch.zeros((batch, p, p, 3), dtype=torch.float32, device=device)
    dtype = model_dtype(cfg)

    eager = _EvalForward(bundle.encoder, bundle.decoder)
    custom_ops.reset_launches()
    with torch.no_grad():
        eager(x)   # the route of this batch: its launches, the operands it reads
    launches = {k: v for k, v in custom_ops.read_launches().items() if v}
    holders = [m for m in eager.modules() if isinstance(m, KernelParams)
               and dtype in m.cached_dtypes()]
    templates = [h.kernel_operands(dtype) for h in holders]
    with torch.no_grad():
        ops_bytes, operands = b"", []
        if holders:
            make = _KernelOperands(bundle.encoder, bundle.decoder, holders,
                                   dtype)
            ops_bytes = _program_bytes(torch.export.export(
                _Program(make, names), (weights,)))
            # the forward's example operands, made eagerly (unlifting the
            # fresh program to run it costs more than the export)
            operands = make()
        ep = torch.export.export(_Program(_EvalForward(
            bundle.encoder, bundle.decoder, holders, templates), names),
            (weights, x, operands))
    traced = custom_ops.graph_launches(ep.graph)
    if traced != launches:
        raise RuntimeError(f"the program holds the launches {traced}, an eager "
                           f"call of its batch makes {launches}")
    forward_bytes = _program_bytes(ep)

    buf = io.BytesIO()
    np.savez(buf, *(v.detach().cpu().numpy() for v in
                    list(enc_state.values()) + list(dec_state.values())))
    npz = buf.getvalue()
    meta = json.dumps({
        "format": VERSION,
        "input_shape": [batch, p, p, 3],
        "input_dtype": "float32",
        "device": device.type,
        "eval_dtype": cfg.eval_dtype,
        "encoder_type": cfg.encoder_type,
        "decoder_type": cfg.decoder_type,
        "enc_paths": enc_paths,
        "dec_paths": dec_paths,
        "weights_len": len(npz),
        "programs": {"forward": len(forward_bytes), "operands": len(ops_bytes)},
        "operands": len(operands),
        "launches": launches,
        "kernels": build.source_hash(),
        "torch_version": torch.__version__,
    }).encode()
    header = MAGIC + struct.pack("<II", VERSION, len(meta))
    return header + meta + npz + forward_bytes + ops_bytes


@dataclasses.dataclass(frozen=True)
class ServingModel:
    """A loaded restoration server: ``model(tiles) -> restored``."""

    meta: dict
    device: torch.device
    weights: List[torch.Tensor]
    operands: List[torch.Tensor]
    program: "torch.export.ExportedProgram"
    _call: torch.nn.Module

    @property
    def input_shape(self) -> Tuple[int, ...]:
        return tuple(self.meta["input_shape"])

    def __call__(self, tiles) -> torch.Tensor:
        """Restore a ``[b, p, p, 3]`` float32 tile batch (numpy or torch) of
        at most the exported batch: it is zero-padded to that batch and the
        pad rows are dropped from the output, a float32 tensor on the
        artifact's device."""
        tiles = torch.as_tensor(tiles, dtype=torch.float32)
        b_exp, shape = self.input_shape[0], self.input_shape[1:]
        if tiles.dim() != 4 or tuple(tiles.shape[1:]) != shape:
            raise ValueError(f"expected tiles [*, {', '.join(map(str, shape))}]"
                             f", got {tuple(tiles.shape)}")
        b = tiles.shape[0]
        if b > b_exp:
            raise ValueError(f"batch {b} exceeds the exported batch {b_exp}; "
                             "split it into chunks")
        tiles = tiles.to(self.device)
        if b < b_exp:
            tiles = torch.cat([tiles, tiles.new_zeros((b_exp - b,) + shape)])
        with torch.no_grad():
            # forward, not __call__: the module's input check walks every
            # weight on every call; the tiles are checked above, and the
            # weights and operands are the artifact's own
            out = self._call.forward(self.weights, tiles, self.operands)
        return out[:b]


def loads(blob: bytes, device=None) -> ServingModel:
    """The :class:`ServingModel` of an artifact's bytes, on ``device``
    (None: the device it was exported for). A CUDA artifact runs on the
    card only; loading it with ``device="cpu"`` raises."""
    if blob[:8] != MAGIC:
        raise ValueError("not a FAIRM serving artifact of the PyTorch port")
    version, mlen = struct.unpack("<II", blob[8:16])
    if version != VERSION:
        raise ValueError(f"unsupported artifact version {version}")
    meta = json.loads(blob[16:16 + mlen].decode())
    want = meta["device"]
    device = torch.device(want) if device is None else torch.device(device)
    if device.type != want:
        raise ValueError(f"the artifact was exported for {want}; it does not "
                         f"run on {device.type}")
    if want == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a CUDA artifact needs an NVIDIA GPU")
        if meta["kernels"] != build.source_hash():
            raise ValueError(f"the artifact was exported against kernel "
                             f"sources {meta['kernels']}, this checkout has "
                             f"{build.source_hash()}")
    woff = 16 + mlen
    wlen = meta["weights_len"]
    n = len(meta["enc_paths"]) + len(meta["dec_paths"])
    with np.load(io.BytesIO(blob[woff:woff + wlen])) as z:
        weights = [torch.from_numpy(z[f"arr_{i}"]).to(device) for i in range(n)]
    at = woff + wlen
    flen, olen = meta["programs"]["forward"], meta["programs"]["operands"]
    program = torch.export.load(io.BytesIO(blob[at:at + flen]))
    operands = []
    if olen:
        with torch.no_grad():
            operands = list(torch.export.load(io.BytesIO(
                blob[at + flen:at + flen + olen])).module()(weights))
    return ServingModel(meta=meta, device=device, weights=weights,
                        operands=operands, program=program,
                        _call=program.module())


def save(path: str, blob: bytes) -> None:
    with open(path, "wb") as f:
        f.write(blob)


def load(path: str, device=None) -> ServingModel:
    with open(path, "rb") as f:
        return loads(f.read(), device)
