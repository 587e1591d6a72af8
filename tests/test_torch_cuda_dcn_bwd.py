"""The DCN backward K14 against its plain version, K7 at the widths that
fall off its vector paths, and a tiny ``resnet_dgrn`` training step run
twice from one state, on the card.

Every test here is marked ``cuda`` and skips where there is no NVIDIA GPU.
The file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_dcn_bwd.py

``chip_smoke.py`` checks the main path's shapes (phases 8, 14 and 15).
"""

import copy

import pytest
import torch

from frequency_wised_all_in_one_image_restoration_model_tpu_torch import config
from frequency_wised_all_in_one_image_restoration_model_tpu_torch.data import (
    synthetic)
from frequency_wised_all_in_one_image_restoration_model_tpu_torch.models import (
    airnet)
from frequency_wised_all_in_one_image_restoration_model_tpu_torch.ops import (
    deform_conv as dc)
from frequency_wised_all_in_one_image_restoration_model_tpu_torch.ops.kernels import (
    lewin_block as lb)
from frequency_wised_all_in_one_image_restoration_model_tpu_torch.training import (
    checkpoint as ckpt, state as train_state, steps)

# a backward kernel against its twin, every output: max|kernel - plain| over
# max(1, own largest, 1% of the case's largest) (chip_smoke.py BWD_TOL)
TOL = {torch.float32: 2e-4, torch.bfloat16: 3e-2}
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _check_all(got, want, dtype):
    assert len(got) == len(want)
    floor = max([1.0] + [1e-2 * float(w.float().abs().max())
                         for w in want[1:] if w is not None])
    for i, (a, b) in enumerate(zip(got, want)):
        if b is None:
            assert a is None, i
            continue
        assert a.shape == b.shape and a.dtype == b.dtype, i
        a, b = a.float(), b.float()
        assert torch.isfinite(a).all(), i
        err = float((a - b).abs().max()) / max(
            floor if i else 1.0, float(b.abs().max()))
        assert err <= TOL[dtype], (i, err)


def _dcn_inputs(gen, B, res, C, Cout, dtype, bias, dilation=1):
    """Offsets up to +-3.5 (past every edge), a few of them on integer
    coordinates and on the -1 / H rims, the modulation away from 0 and 1."""
    K = 9
    x = (torch.randn(B, res, res, C, generator=gen, device="cuda") * 0.5)
    off = torch.rand(B, res, res, 2 * K, generator=gen, device="cuda") * 7 - 3.5
    off[:, ::3, ::2] = off[:, ::3, ::2].round()
    off[:, 0, :, 0] = -1.0 + dilation   # tap (0, 0) of row 0 lands on y = -1
    off[:, -1, :, K - 1] = 1.0 - dilation  # tap (2, 2) of the last row: y = H
    mask = 0.1 + 0.8 * torch.rand(B, res, res, K, generator=gen, device="cuda")
    w = torch.randn(3, 3, C, Cout, generator=gen, device="cuda") * (9 * C) ** -0.5
    b = torch.randn(Cout, generator=gen, device="cuda") * 0.1 if bias else None
    g = torch.randn(B, res, res, Cout, generator=gen, device="cuda")
    return [x.to(dtype), off.to(dtype), mask.to(dtype), w.to(dtype), b,
            g.to(dtype)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,res,C,Cout,dil,bias", [
    (4, 128, 64, 64, 1, False),    # DGRN's DCNLayer
    (4, 128, 112, 112, 1, False),  # the deform LeFF at res 128
    (4, 16, 896, 896, 1, False),   # the deform LeFF at res 16
    (2, 20, 10, 6, 2, True),       # dilation 2, C off the vector path
    (3, 12, 3, 3, 1, True),        # ViT + DGRN's three features
    (3, 20, 16, 32, 1, True),      # the fused route, a short last tile
    (1, 12, 112, 48, 1, False),    # the passes in bf16, one tile of pixels
])
def test_dcn_bwd_kernel_matches_plain(card, dtype, B, res, C, Cout, dil, bias):
    """K14 against ``dcn_bwd_plain``, every output, and equal bits on a
    second launch."""
    x, off, mask, w, b, g = _dcn_inputs(card, B, res, C, Cout, dtype, bias, dil)
    dc.reset_launches()
    got = dc.dcn_bwd(x, off, mask, w, b, g, dil, dil)
    again = dc.dcn_bwd(x, off, mask, w, b, g, dil, dil)
    torch.cuda.synchronize()
    assert dc.LAUNCHES["dcn_bwd"] == 2
    assert all(torch.equal(p, q) for p, q in zip(got, again) if p is not None)
    _check_all(got, dc.dcn_bwd_plain(x, off, mask, w, b, g, dil, dil), dtype)


def _edge_offsets(B, res, where):
    """Offsets [B, res, res, 18] that send every sample of an image to the
    point (res / 2 + 0.5, res / 2 + 0.5) (one bucket of res^2 * 9 samples:
    half-integers, exact in bf16), onto integer coordinates, or beyond the
    rim (no sample reads a pixel)."""
    if where == "integer":
        g = torch.Generator(device="cuda").manual_seed(1)
        return torch.randint(-3, 4, (B, res, res, 18), generator=g,
                             device="cuda").float()
    if where == "beyond the rim":
        sign = torch.ones(B, res, res, 18, device="cuda")
        sign[..., 1::2] = -1.0
        return sign * (res + 5.0)
    i = torch.arange(res, device="cuda", dtype=torch.float32)
    t = torch.arange(3, device="cuda", dtype=torch.float32)
    c = res / 2 + 0.5
    dy = (c - (i[:, None, None, None] - 1 + t[None, None, :, None])).expand(
        res, res, 3, 3).reshape(res, res, 9)
    dx = (c - (i[None, :, None, None] - 1 + t[None, None, None, :])).expand(
        res, res, 3, 3).reshape(res, res, 9)
    return torch.cat([dy, dx], -1)[None].expand(B, res, res, 18).contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("where", ["one pixel", "integer", "beyond the rim"])
@pytest.mark.parametrize("C", [64, 24])
def test_dcn_bwd_kernel_at_the_edges_of_its_grouping(card, dtype, where, C):
    """K14 against ``dcn_bwd_plain`` where the grouping by pixel is at its
    edges: every sample of an image in one bucket, every sample on integer
    coordinates, every sample beyond the rim; equal bits on a second
    launch."""
    B, res = 2, 24
    x, _, mask, w, b, g = _dcn_inputs(card, B, res, C, C, dtype, True)
    off = _edge_offsets(B, res, where).to(dtype)
    got = dc.dcn_bwd(x, off, mask, w, b, g)
    again = dc.dcn_bwd(x, off, mask, w, b, g)
    torch.cuda.synchronize()
    assert all(torch.equal(p, q) for p, q in zip(got, again) if p is not None)
    want = dc.dcn_bwd_plain(x, off, mask, w, b, g)
    if where == "beyond the rim":
        assert not want[0].float().abs().max()
    _check_all(got, want, dtype)


@pytest.mark.cuda
def test_dcn_function_runs_the_kernel_backward(card):
    """``DCNFn`` on CUDA tensors: K11 forward, K14 backward, the gradients
    in the inputs' dtypes."""
    x, off, mask, w, _, g = _dcn_inputs(card, 2, 16, 24, 16, torch.float32,
                                        False)
    ins = [t.requires_grad_() for t in (x, off, mask, w)]
    dc.reset_launches()
    got = torch.autograd.grad(dc.DCNFn.apply(*ins, None, 1, 1), ins, g)
    assert dc.LAUNCHES == {"dcn": 1, "dcn_bwd": 1}
    with torch.no_grad():
        want = dc.dcn_bwd_plain(x, off, mask, w, None, g)[:4]
    _check_all(got, want, torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("C,Hd,res", [(5, 20, 16), (6, 22, 16), (10, 40, 24),
                                      (8, 36, 8)])
def test_ffn_bwd_kernel_off_the_vector_paths(card, dtype, C, Hd, res):
    """K7 at widths that are not multiples of 8 (C = 5, 6, 10; Hd = 20, 22,
    36) against its twin; a second launch gives equal bits."""
    gen = card
    rnd = lambda *s, scale=1.0: torch.randn(*s, generator=gen,
                                            device="cuda") * scale
    B = 3
    x, g = rnd(B, res, res, C).to(dtype), rnd(B, res, res, C).to(dtype)
    args = [x, g, 1 + rnd(C, scale=0.1), rnd(C, scale=0.1),
            rnd(C, Hd, scale=C ** -0.5), rnd(Hd, scale=0.1),
            rnd(3, 3, Hd, scale=1 / 3), rnd(Hd, scale=0.1),
            rnd(Hd, C, scale=Hd ** -0.5), rnd(C, scale=0.1), 1e-6]
    lb.reset_launches()
    got = lb.ffn_block_bwd(*args)
    again = lb.ffn_block_bwd(*args)
    assert lb.LAUNCHES["lewin_ffn_bwd"] == 2
    assert all(torch.equal(p, q) for p, q in zip(got, again))
    _check_all(got, lb.ffn_block_bwd_plain(*args), dtype)


def _snapshot(state, metrics):
    """Every bit a step leaves: loss, parameters, Adam's moments, queue."""
    out = {"loss": metrics["loss"].clone(), "queue": state.moco.queue.clone(),
           "ptr": state.moco.queue_ptr.clone()}
    for i, p in enumerate(state.parameters()):
        out[f"p{i}"] = p.detach().clone()
        st = state.optimizer.state.get(p, {})
        for k in ("exp_avg", "exp_avg_sq"):
            if k in st:
                out[f"{k}{i}"] = st[k].clone()
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tiny_resnet_dgrn_steps_repeat_bit_for_bit(card, dtype):
    """Two joint steps of a tiny ``resnet_dgrn`` (P = 32, one DGRN group of
    two blocks, offset heads live) run twice from one saved state on a
    fresh generator of the same seed give equal bits."""
    cfg = config.make_config(
        patch_size=32, crop_test_imgs_size=32, encoder_type="ResNet",
        decoder_type="ResNet", encoder_dim=32, dgrn_groups=1, dgrn_blocks=2,
        de_type=["2tasks"], dtype=dtype, synthetic_data=True, seed=1)
    bundle = airnet.build_models(cfg, "cuda", eval_mode=False)
    gen = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for name, p in bundle.decoder.named_parameters():
            if "conv_offset_mask" in name:
                p.copy_(torch.rand(p.shape, generator=gen) * 7 - 3.5
                        if name.endswith("bias")
                        else 0.1 * torch.randn(p.shape, generator=gen))
    state = train_state.create_train_state(cfg, bundle)
    saved = copy.deepcopy(ckpt.state_tree(state))
    loader = synthetic.SyntheticTrainLoader(cfg, seed=0)
    batches = [steps.array_batch(loader.next_batch(), "cuda") for _ in range(2)]
    step = steps.make_train_step(cfg, bundle, joint=True)
    runs = []
    for _ in range(2):
        ckpt.load_state_tree(state, saved)
        state.generator = torch.Generator(device="cuda").manual_seed(cfg.seed)
        dc.reset_launches()
        for batch in batches:
            state, metrics = step(state, batch)
        torch.cuda.synchronize()
        assert dc.LAUNCHES["dcn_bwd"] == 2 * 4  # 4 DCNs a step
        runs.append(_snapshot(state, metrics))
    assert runs[0].keys() == runs[1].keys()
    differ = [k for k in runs[0] if not torch.equal(runs[0][k], runs[1][k])]
    assert not differ, differ
