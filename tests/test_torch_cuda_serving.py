"""The serving path on the card: the forward kernels as ``fairm::`` custom
ops (``ops/kernels/custom_ops.py``) and the exported eval forward
(``serving.py``).

* Every ``fairm::`` op passes ``torch.library.opcheck`` (its schema, its
  fake function against the real launch, its tracing) on the operands an
  eager forward of a model hands it: the flagship by the chain, the merged
  and the split routes, the per-scale set (K9, the deformable LeFF's K11)
  and ``resnet_dgrn`` (DGRN's K11), at full width, the Uformers capped to
  one block a stage, B = 2, in bfloat16 and float32.
* The served program of those models (default route) against their eager
  forward: float32 within 1e-4 of ``max(1, max|eager|)``, bfloat16 within
  1e-2 (the port's whole-forward bound), the program's ``fairm::`` nodes
  and the launches of one served call equal to the eager forward's.

Every test here is marked ``cuda`` and skips where there is no NVIDIA GPU.
The file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_serving.py

``chip_smoke.py`` phase 16 serves the full-depth models.
"""

import pytest
import torch

from frequency_wised_all_in_one_image_restoration_model_tpu_torch import (
    config, serving)
from frequency_wised_all_in_one_image_restoration_model_tpu_torch.models import (
    airnet)
from frequency_wised_all_in_one_image_restoration_model_tpu_torch.ops import (
    deform_conv as dc)
from frequency_wised_all_in_one_image_restoration_model_tpu_torch.ops.kernels import (
    custom_ops, lewin_block as lb, window_attention as wa)

DTYPES = ["bfloat16", "float32"]
TOL = {"float32": 1e-4, "bfloat16": 1e-2}
B = 2
MODELS = {
    "flagship": dict(encoder_type="Uformer", decoder_type="Uformer", L=3,
                     encoder_msa_type="freq",
                     degradation_embedding_method=["all_DC"]),
    "per_scale_set": dict(
        encoder_type="Uformer", decoder_type="Uformer", L=3,
        encoder_msa_type="freq", learnable_modulator=True,
        degradation_embedding_method=["residual", "modulator",
                                      "self_modulator", "deform_conv",
                                      "attention_kv"]),
    "resnet_dgrn": dict(encoder_type="ResNet", decoder_type="ResNet"),
}
# the routes whose launches opcheck sees: the flagship by every route
ROUTES = [("flagship", "kernel"), ("flagship", "merged"),
          ("flagship", "split"), ("per_scale_set", "default"),
          ("resnet_dgrn", "default")]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator().manual_seed(0)


def _bundle(name, dtype, impl="default"):
    cfg = config.make_config(**MODELS[name], eval_dtype=dtype,
                             uformer_depth_cap=1, dgrn_groups=1,
                             dgrn_blocks=1, seed=0)
    bundle = airnet.build_models(cfg, "cuda", impl)
    # live DCN offsets and band gains (they start at zero)
    gen = torch.Generator().manual_seed(7)
    with torch.no_grad():
        for pname, p in [*bundle.decoder.named_parameters(),
                         *bundle.encoder.named_parameters()]:
            if "conv_offset_mask" in pname or pname.endswith(".lamb"):
                p.copy_(0.3 * torch.randn(p.shape, generator=gen))
    return cfg, bundle


def _tiles(cfg, gen, b=B):
    p = cfg.crop_test_imgs_size
    return torch.rand((b, p, p, 3), generator=gen).cuda()


def _launches():
    return {k: v for k, v in custom_ops.read_launches().items() if v}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name,impl", ROUTES,
                         ids=[f"{n}-{i}" for n, i in ROUTES])
def test_opcheck(card, monkeypatch, name, impl, dtype):
    """``torch.library.opcheck`` on each op a forward launches, once per
    op and form (its int, float and bool arguments), on the operands the
    wrappers made for it."""
    cfg, bundle = _bundle(name, dtype, impl)
    calls = {}

    def record(op, launch, *args):
        form = tuple(a for a in args if isinstance(a, (bool, int, float)))
        # the ops are forward-only, as a served program calls them: the
        # operands without the parameters' autograd history
        calls.setdefault((op, form), tuple(
            a.detach() if torch.is_tensor(a) else a for a in args))
        return launch(*args)

    for m in (lb, wa, dc):
        monkeypatch.setattr(m, "_launch", record)
    x = _tiles(cfg, card)
    with torch.no_grad():   # not eval_forward's inference mode: opcheck
        bundle.decoder(x, bundle.encoder.features(x))   # reruns the ops
    assert calls
    for (op, _), args in calls.items():
        torch.library.opcheck(getattr(torch.ops.fairm, op).default, args)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", list(MODELS))
def test_served_matches_eager(card, name, dtype):
    """The served program against the eager forward of its weights (default
    route), a short batch too; its launches those of the eager forward."""
    cfg, bundle = _bundle(name, dtype)
    x = _tiles(cfg, card, B + 1)
    custom_ops.reset_launches()
    want = airnet.eval_forward(bundle, x)
    eager = _launches()
    blob = serving.export_eval(
        cfg, (bundle.encoder.state_dict(), bundle.decoder.state_dict()),
        batch=B + 1)
    model = serving.loads(blob)
    assert model.meta["device"] == "cuda" and model.meta["launches"] == eager
    assert custom_ops.graph_launches(model.program.graph) == eager
    custom_ops.reset_launches()
    got = model(x)
    torch.cuda.synchronize()
    assert _launches() == eager
    short = model(x[:B].cpu().numpy())
    for out, ref in ((got, want), (short, want[:B])):
        assert out.dtype == torch.float32 and out.device.type == "cuda"
        assert out.shape == ref.shape and torch.isfinite(out).all()
        err = (out - ref).abs().max().item() / max(1.0, ref.abs().max().item())
        assert err <= TOL[dtype], err
    with pytest.raises(ValueError, match="exported for cuda"):
        serving.loads(blob, device="cpu")
