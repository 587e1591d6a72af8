"""The split block kernels K12 / K13 against their plain PyTorch versions
and the chain kernels K1 / K2 (both forms of K12, the roll folded into it;
K13's parts), and the tiny model families by the default and the plain
route, on the card.

Every test here is marked ``cuda`` and skips where there is no NVIDIA GPU.
The file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_backbones.py

``chip_smoke.py`` checks the flagship shapes (phases 13 and 14).
"""

import pytest
import torch

from frequency_wised_all_in_one_image_restoration_model_tpu_torch import config
from frequency_wised_all_in_one_image_restoration_model_tpu_torch.models import (
    airnet)
from frequency_wised_all_in_one_image_restoration_model_tpu_torch.ops import (
    deform_conv as dc, windows)
from frequency_wised_all_in_one_image_restoration_model_tpu_torch.ops.kernels import (
    lewin_block as lb)

# max|kernel - plain| / max(1, max|plain|)
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
DTYPES = [torch.float32, torch.bfloat16]
P = 32


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _rnd(gen, *shape, scale=1.0):
    return torch.randn(*shape, generator=gen, device="cuda") * scale


def _check(got, want, tol):
    assert got.shape == want.shape and got.dtype == want.dtype
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all()
    err = (got - want).abs().max().item() / max(1.0, want.abs().max().item())
    assert err <= tol, err


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("C,h,res,win,shift,kb,path", [
    (128, 4, 16, 8, 4, 2, "fused"), (96, 3, 8, 8, 0, 1, "fused"),
    (256, 8, 16, 8, 0, 4, "fused"), (128, 1, 16, 8, 4, 2, "passes"),
    (128, 2, 8, 4, 2, 2, "passes")])
def test_attn_split_kernel_matches_plain(card, dtype, C, h, res, win, shift,
                                         kb, path):
    """K12 with the mask, lam and DropPath, ``kb`` parts of the projection
    (C = 96: three k-tiles, not a multiple of the tile widths; in bf16 each
    part whole 64-wide k-tiles), by both forms: fused (8 x 8 windows, head
    dims up to 64) and four passes (a head dim of 128; 4 x 4 windows); a
    second launch gives equal bits."""
    assert lb.attn_split_path(C, h, win) == path
    B, d, n = 3, C // h, win * win
    x = _rnd(card, B, res, res, C).to(dtype)
    w = [1 + _rnd(card, C, scale=0.1), _rnd(card, C, scale=0.1)]
    for _ in range(3):
        w += [_rnd(card, h, C, d, scale=C ** -0.5), _rnd(card, h, d, scale=0.1)]
    w += [_rnd(card, h, d, C, scale=C ** -0.5), _rnd(card, C, scale=0.1),
          _rnd(card, h, n, n, scale=0.05)]
    mask = (torch.from_numpy(windows.shift_attn_mask(res, res, win, shift))
            .cuda() if shift else None)
    lam = _rnd(card, B, h, scale=0.3)
    dps = torch.tensor([2.0, 0.0, 1.0], device="cuda")
    lb.reset_launches()
    got = lb.block_attention_split(x, *w, mask, lam, win, 1e-6, dps, kb)
    again = lb.block_attention_split(x, *w, mask, lam, win, 1e-6, dps, kb)
    assert lb.LAUNCHES["lewin_attn_split"] == 2
    assert torch.equal(got, again)
    _check(got, lb.lewin_attn_split_plain(x, *w, mask, lam, win, 1e-6, dps,
                                          kb), TOL[dtype])
    _check(got, lb.block_attention_plain(x, *w, mask, lam, win, 1e-6, dps),
           TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("C,Hd,res,kb", [(8, 512, 16, 4), (64, 256, 8, 2),
                                         (24, 96, 16, 1)])
def test_ffn_split_kernel_matches_plain(card, dtype, C, Hd, res, kb):
    """K13 with DropPath over ``kb`` hidden blocks (Hd = 96: a padded
    reduction); a second launch gives equal bits."""
    B = 2
    x = _rnd(card, B, res, res, C).to(dtype)
    w = [1 + _rnd(card, C, scale=0.1), _rnd(card, C, scale=0.1),
         _rnd(card, C, Hd, scale=C ** -0.5), _rnd(card, Hd, scale=0.1),
         _rnd(card, 3, 3, Hd, scale=1 / 3), _rnd(card, Hd, scale=0.1),
         _rnd(card, Hd, C, scale=Hd ** -0.5), _rnd(card, C, scale=0.1)]
    dps = torch.tensor([0.0, 1.25], device="cuda")
    lb.reset_launches()
    got = lb.block_ffn_split(x, *w, 1e-6, dps, kb)
    assert torch.equal(got, lb.block_ffn_split(x, *w, 1e-6, dps, kb))
    assert lb.LAUNCHES["lewin_ffn_split"] == 2
    _check(got, lb.lewin_ffn_split_plain(x, *w, 1e-6, dps, kb), TOL[dtype])
    _check(got, lb.block_ffn_plain(x, *w, 1e-6, dps), TOL[dtype])


def _roll(x, shift):
    return torch.roll(x, (shift, shift), dims=(1, 2)) if shift else x


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B", [1, 3, 4, 16])
@pytest.mark.parametrize("res,shift", [(8, 0), (16, 0), (16, 4)])
@pytest.mark.parametrize("with_lam,with_dps", [(True, True), (False, False),
                                               (True, False), (False, True)])
def test_attn_split_fused_matches_plain_and_chain(card, dtype, B, res, shift,
                                                  with_lam, with_dps):
    """K12's fused form (a block per window and head) at C = 224, h = 4
    (d = 56, as at the C = 896 stages; kpad(C) = 224 ends inside a 64-wide
    k-tile), on the true-layout image with the roll folded in (``shift``),
    against the plain twin and against K1, which compute the same function,
    both around torch.roll; a second launch gives equal bits."""
    C, h, n = 224, 4, 64
    d = C // h
    assert lb.attn_split_path(C, h, 8) == "fused"
    x = _rnd(card, B, res, res, C).to(dtype)
    w = [1 + _rnd(card, C, scale=0.1), _rnd(card, C, scale=0.1)]
    for _ in range(3):
        w += [_rnd(card, h, C, d, scale=C ** -0.5), _rnd(card, h, d, scale=0.1)]
    w += [_rnd(card, h, d, C, scale=C ** -0.5), _rnd(card, C, scale=0.1),
          _rnd(card, h, n, n, scale=0.05)]
    mask = (torch.from_numpy(windows.shift_attn_mask(res, res, 8, shift))
            .cuda() if shift else None)
    lam = _rnd(card, B, h, scale=0.3) if with_lam else None
    dps = (torch.arange(B, device="cuda") % 3).float() * 0.75 if with_dps \
        else None
    op = lb.attn_operands(*w[2:], dtype)
    lb.reset_launches()
    got = lb.attention_split_kernel(x, *w[:2], op, mask, lam, 8, 1e-6, dps,
                                    shift=shift)
    again = lb.attention_split_kernel(x, *w[:2], op, mask, lam, 8, 1e-6, dps,
                                      shift=shift)
    assert lb.LAUNCHES["lewin_attn_split"] == 2
    assert torch.equal(got, again)
    xr = _roll(x, -shift)
    kb = lb.split_parts(B * res * res, C, C, dtype)
    _check(got, _roll(lb.lewin_attn_split_plain(xr, *w, mask, lam, 8, 1e-6,
                                                dps, kb), shift), TOL[dtype])
    _check(got, _roll(lb.block_attention(xr, *w, mask, lam, 8, 1e-6, dps),
                      shift), TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B", [1, 3, 4, 16])
@pytest.mark.parametrize("res", [8, 16])
@pytest.mark.parametrize("with_dps", [True, False])
def test_ffn_split_default_matches_plain_and_chain(card, dtype, B, res,
                                                   with_dps):
    """K13 with its default hidden blocks at C = 224, Hd = 896, against
    the plain twin and against K2; a second launch gives equal bits."""
    C, Hd = 224, 896
    x = _rnd(card, B, res, res, C).to(dtype)
    w = [1 + _rnd(card, C, scale=0.1), _rnd(card, C, scale=0.1),
         _rnd(card, C, Hd, scale=C ** -0.5), _rnd(card, Hd, scale=0.1),
         _rnd(card, 3, 3, Hd, scale=1 / 3), _rnd(card, Hd, scale=0.1),
         _rnd(card, Hd, C, scale=Hd ** -0.5), _rnd(card, C, scale=0.1)]
    dps = (torch.arange(B, device="cuda") % 3).float() * 0.75 if with_dps \
        else None
    kb = lb.split_parts(B * res * res, C, Hd, dtype)
    lb.reset_launches()
    got = lb.block_ffn_split(x, *w, 1e-6, dps)
    assert torch.equal(got, lb.block_ffn_split(x, *w, 1e-6, dps))
    assert lb.LAUNCHES["lewin_ffn_split"] == 2
    _check(got, lb.lewin_ffn_split_plain(x, *w, 1e-6, dps, kb), TOL[dtype])
    _check(got, lb.block_ffn(x, *w, 1e-6, dps), TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("C,Hd,kb", [(40, 896, 7), (40, 896, 14),
                                     (64, 192, 3), (128, 3584, 8)])
def test_ffn_split_parts(card, dtype, C, Hd, kb):
    """K13's fc2 in kb parts, in bf16 in one launch of whole 64-column
    k-tiles (Hd = 896 in 7 parts and in 14 of one k-tile each, 192 in 3,
    3584 in 8); C = 40 pads the reduction of fc1."""
    B = 3
    x = _rnd(card, B, 8, 8, C).to(dtype)
    w = [1 + _rnd(card, C, scale=0.1), _rnd(card, C, scale=0.1),
         _rnd(card, C, Hd, scale=C ** -0.5), _rnd(card, Hd, scale=0.1),
         _rnd(card, 3, 3, Hd, scale=1 / 3), _rnd(card, Hd, scale=0.1),
         _rnd(card, Hd, C, scale=Hd ** -0.5), _rnd(card, C, scale=0.1)]
    dps = torch.tensor([1.0, 0.0, 2.0], device="cuda")
    got = lb.block_ffn_split(x, *w, 1e-6, dps, kb)
    assert torch.equal(got, lb.block_ffn_split(x, *w, 1e-6, dps, kb))
    _check(got, lb.lewin_ffn_split_plain(x, *w, 1e-6, dps, kb), TOL[dtype])
    _check(got, lb.block_ffn(x, *w, 1e-6, dps), TOL[dtype])


def _liven(bundle, seed=3):
    """Random DCN offset heads and lamb, so that they matter."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for net in (bundle.encoder, bundle.decoder):
            for name, p in net.named_parameters():
                if "conv_offset_mask" in name and name.endswith("bias"):
                    p.copy_((torch.rand(p.shape, generator=gen) * 7 - 3.5))
                elif "conv_offset_mask" in name:
                    p.copy_(0.1 * torch.randn(p.shape, generator=gen))
                elif name.endswith(".lamb"):
                    p.copy_(0.5 * torch.randn(p.shape, generator=gen))


FAMILIES = {
    "resnet_dgrn": dict(encoder_type="ResNet", decoder_type="ResNet",
                        encoder_dim=32),
    "vit_freq": dict(encoder_type="ViT", decoder_type="ResNet",
                     frequency_decompose_type="DC"),
    "resnet_uformer": dict(encoder_type="ResNet", decoder_type="Uformer",
                           encoder_dim=32),
    "origin_l1_uformer": dict(encoder_msa_type="origin", L=1),
    "flagship_split": dict(degradation_embedding_method=["all_DC"]),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(FAMILIES))
def test_tiny_family_default_route_against_plain(card, name):
    """Eval forward fp32 of a tiny model (P=32, widths 8, one DGRN group of
    two blocks) by the default (the flagship: the split) route against the
    plain route; DGRN launches K11 once per DGM."""
    cfg = config.make_config(**{
        **dict(patch_size=P, crop_test_imgs_size=P, encoder_embed_dim=8,
               embed_dim=8, uformer_depth_cap=2, dgrn_groups=1,
               dgrn_blocks=2, de_type=["2tasks"], seed=1),
        **FAMILIES[name]})
    x = torch.rand(2, P, P, 3, generator=card, device="cuda")
    outs = {}
    for impl in ("split" if name == "flagship_split" else "default", "plain"):
        bundle = airnet.build_models(cfg, "cuda", impl)
        _liven(bundle)
        lb.reset_launches()
        dc.reset_launches()
        outs[impl] = airnet.eval_forward(bundle, x)
        torch.cuda.synchronize()
        if impl == "plain":
            assert not any(lb.LAUNCHES.values()) and not dc.LAUNCHES["dcn"]
        elif cfg.decoder_type == "ResNet":
            assert dc.LAUNCHES["dcn"] == 4
        elif impl == "split":
            assert lb.LAUNCHES["lewin_attn_split"] > 0
            assert lb.LAUNCHES["lewin_ffn_split"] > 0
        else:
            assert lb.LAUNCHES["lewin_attn"] > 0
    plain = outs.pop("plain")
    (routed,) = outs.values()
    _check(routed, plain, 1e-3)
