"""The analysis path and the LeWin leftovers on the card: ``chip_smoke.py``
phase 17's checks (a)-(d) at a small depth (the flagship at full width with
one block a stage, float32, B=2; the leftover stages at B=4), the default
route (the kernels) against the plain route (the twins):

* (a) ``collect_embeddings`` and ``latent_band_histogram``: 1e-3 of
  ``max(1, max|plain|)``;
* (b) a capture of encoder and decoder: one map per attention layer, the
  band energies finite and summing to 1, the captured output against the
  eval forward (1e-3), no launch in a captured forward, each
  ``embed_lamb_1`` equal to ``WindowAttention.lam`` bit for bit;
* (c) LFS: the loss (1e-4), every gradient on the fp32 joint step's
  measure (1e-2), K6 / K7 / K8 launched, none on the plain route;
* (d) a stage of two blocks with ``token_projection='conv'``,
  ``token_mlp='ffn'`` / ``'mlp'`` at res 128 C=56 and res 8 C=896, bf16 and
  fp32: forward at the per-kernel bound (1e-4 / 2e-2: the stage's output is
  in the compute dtype at |y| up to about 5, where one bf16 ulp is 6e-3 of
  it) and every gradient (5e-4 / 6e-2; a parameter's gradient, a sum over
  the rows, against ``max(1, its largest value, 1% of the largest of
  any)``), K9 and K10 launched.

Every test is marked ``cuda`` and skips where there is no NVIDIA GPU. The
file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_analysis.py
"""

import numpy as np
import pytest
import torch
from torch import nn

from frequency_wised_all_in_one_image_restoration_model_tpu_torch import config
from frequency_wised_all_in_one_image_restoration_model_tpu_torch.analysis import (
    embeddings, frequency_dist, msa_frequency)
from frequency_wised_all_in_one_image_restoration_model_tpu_torch.models import (
    airnet, layers, uformer_lewin)
from frequency_wised_all_in_one_image_restoration_model_tpu_torch.ops.kernels import (
    lewin_block as lb, window_attention as wa)
from frequency_wised_all_in_one_image_restoration_model_tpu_torch.scripts import (
    common, plot_LFS_distribution)
from frequency_wised_all_in_one_image_restoration_model_tpu_torch.training.loop import (
    build_train_loader)

B = 2
TOL = 1e-3
KERNEL_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
FUNCTION_TOL = {torch.float32: 5e-4, torch.bfloat16: 6e-2}


def _launches():
    return {**lb.LAUNCHES, **wa.LAUNCHES}


def _reset():
    lb.reset_launches()
    wa.reset_launches()


def _rel(got, want, floor=1.0):
    got = torch.as_tensor(got).detach().float()
    want = torch.as_tensor(want).detach().float()
    assert torch.isfinite(got).all()
    return float((got - want).abs().max()) / max(floor,
                                                 float(want.abs().max()))


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@pytest.fixture(scope="module")
def flagship(card):
    cfg = config.make_config(
        encoder_type="Uformer", decoder_type="Uformer", L=3,
        encoder_msa_type="freq", degradation_embedding_method=["all_DC"],
        de_type=["denoising_0", "deraining"], uformer_depth_cap=1,
        synthetic_data=True, seed=0)
    bundles = {impl: airnet.build_models(cfg, "cuda", impl)
               for impl in ("default", "plain")}
    loader = build_train_loader(cfg, seed=0)
    return cfg, bundles, [loader.next_batch() for _ in range(2)]


@pytest.mark.cuda
def test_embeddings_default_matches_plain(flagship):
    cfg, bundles, batches = flagship
    got = {}
    for impl, b in bundles.items():
        def encode(x, b=b):
            with torch.inference_mode():
                return b.encoder(common.images(x, "cuda"))[1]
        _reset()
        emb, _ = embeddings.collect_embeddings(encode, batches)
        hist = frequency_dist.latent_band_histogram(
            lambda x, b=b: common.spatial_inter(b, x), list(batches[0]["d1"]))
        torch.cuda.synchronize()
        counts = _launches()
        assert any(counts.values()) == (impl == "default"), counts
        got[impl] = emb, hist
    assert got["default"][0].shape == (2 * B, cfg.encoder_dim)
    for a, b in zip(got["default"], got["plain"]):
        assert _rel(a, b) <= TOL


@pytest.mark.cuda
def test_capture_maps_and_gains(flagship):
    _, bundles, batches = flagship
    b = bundles["default"]
    x = torch.from_numpy(batches[0]["d1"][:1]).cuda()
    want = airnet.eval_forward(b, x)
    outs = []
    root = nn.ModuleDict({"encoder": b.encoder, "decoder": b.decoder})
    _reset()
    report = msa_frequency.model_attention_band_report(
        lambda t: outs.append(airnet.restore(b, t)), root, x)
    torch.cuda.synchronize()
    assert not any(_launches().values())
    blocks = [m for m in root.modules() if isinstance(m, uformer_lewin.LeWinBlock)]
    assert len(report) == sum(2 if m.msa_type == "freq" else 1 for m in blocks)
    for e in report.values():
        assert np.isfinite(e).all() and abs(float(e.sum()) - 1.0) <= 1e-5
    assert _rel(outs[0], want) <= TOL
    with torch.inference_mode():
        ctx = b.encoder.features(x)
    lambs = embeddings.embed_lamb_responses(b.decoder, x, ctx)
    modules = dict(b.decoder.named_modules())
    assert len(lambs) == sum(isinstance(m, uformer_lewin.LeWinBlock)
                             for m in b.decoder.modules())
    for key, g in lambs.items():
        attn = modules[key.rsplit("/", 2)[0].replace("/", ".")]
        with torch.inference_mode():
            lam = attn.lam(ctx.band_inter, torch.float32)
        assert torch.equal(torch.from_numpy(g).reshape(lam.shape), lam.cpu()), key


@pytest.mark.cuda
def test_lfs_runs_the_backward_kernels(flagship):
    _, bundles, batches = flagship
    runs = {}
    for impl, b in bundles.items():
        _reset()
        runs[impl] = plot_LFS_distribution.lfs_analysis(b, batches[0], batches)
        torch.cuda.synchronize()
        counts = _launches()
        if impl == "default":
            assert all(counts[k] for k in ("lewin_attn_bwd", "lewin_ffn_bwd",
                                           "freq_inter_bwd")), counts
        else:
            assert not any(counts.values()), counts
    run, ref = runs["default"], runs["plain"]
    assert abs(run["loss"] - ref["loss"]) <= 1e-4
    gmax = max(float(g.abs().max()) for g in ref["grads"].values())
    for name, gp in ref["grads"].items():
        assert _rel(run["grads"][name], gp, 1e-3 * gmax) <= 1e-2, name


STAGES = [(128, 56, 1), (8, 896, 16)]
FIELDS = [dict(token_projection="conv"), dict(token_mlp="ffn"),
          dict(token_mlp="mlp")]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("fields", FIELDS, ids=lambda f: "-".join(f.values()))
@pytest.mark.parametrize("res,dim,heads", STAGES)
def test_leftover_stage_default_matches_plain(card, res, dim, heads, fields,
                                              dtype):
    rng = np.random.default_rng(17)
    x0 = torch.from_numpy(rng.standard_normal(
        (4, res * res, dim), dtype=np.float32)).cuda().to(dtype)
    g = torch.from_numpy(rng.standard_normal(x0.shape, dtype=np.float32)).cuda()
    outs = {}
    for impl in ("default", "plain"):
        m = uformer_lewin.BasicUformerLayer(dim, res, 2, heads, impl=impl,
                                            **fields)
        layers.trunc_normal_init(m, torch.Generator().manual_seed(17))
        m = m.cuda()
        x = x0.clone().requires_grad_()
        _reset()
        y = m(x)
        grads = torch.autograd.grad(y, [x, *m.parameters()], g.to(dtype))
        torch.cuda.synchronize()
        counts = _launches()
        assert bool(counts["window_attn"] and counts["window_attn_bwd"]) == (
            impl == "default"), counts
        outs[impl] = y, grads
    (y, gr), (yp, grp) = outs["default"], outs["plain"]
    assert _rel(y, yp) <= KERNEL_TOL[dtype]
    floor = max([1.0] + [1e-2 * float(b.abs().max()) for b in grp[1:]])
    for i, (a, b) in enumerate(zip(gr, grp)):
        assert _rel(a, b, floor if i else 1.0) <= FUNCTION_TOL[dtype], i
