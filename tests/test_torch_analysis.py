"""The port's analysis toolkit (``<port>/analysis/``) against the JAX
package's, on the same seeded inputs:

* ``performance`` and ``frequency_dist`` on the same files and images:
  equal results; ``tsne_embed`` on the same array: equal arrays;
* ``extract_lamb_params`` on a tiny ViT with a DC ``lamb`` (drawn at
  random), weights carried by ``from_jax``: the same keys and values;
* ``attention_band_energy`` and ``gaussian_filter_fft``: 1e-5;
* the tiny flagship of ``test_torch_airnet.py::tiny_cfg`` (P=32, width 4,
  two blocks a stage, one shifted): ``collect_attention_maps`` of the
  encoder and the decoder and ``embed_lamb_responses`` against JAX's sown
  intermediates, every key matched, 1e-5; ``lfs_gradients`` +
  ``taylor_scores`` + ``channel_mask`` against ``jax.grad`` of the same
  objective, the loss and every leaf's gradient at 1e-4 of
  ``max(1, max|g|)`` (and at 1e-3 of the leaf's own largest gradient), the
  scores of every leaf, and the masks equal except where a score lies
  within 1e-3 of the threshold, relative to it.

One module-scoped JAX init of the tiny flagship serves every model test;
torch on one thread. The whole gradient is compared, never the KL term's
part alone: the student and the teacher embed the same images at the same
weights, so that term and its gradient vanish (ROADMAP, R7).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frequency_wised_all_in_one_image_restoration_model_tpu.analysis import (
    embeddings as jemb, frequency_dist as jfd, lfs as jlfs,
    msa_frequency as jmsa, performance as jperf)
from frequency_wised_all_in_one_image_restoration_model_tpu.models import (
    airnet as jairnet, encoder_vit as jvit)
from frequency_wised_all_in_one_image_restoration_model_tpu.ops import (
    frequency as jfrequency)
from frequency_wised_all_in_one_image_restoration_model_tpu_torch import (
    config as tconfig)
from frequency_wised_all_in_one_image_restoration_model_tpu_torch.analysis import (
    embeddings as temb, frequency_dist as tfd, lfs as tlfs,
    msa_frequency as tmsa, performance as tperf)
from frequency_wised_all_in_one_image_restoration_model_tpu_torch.models import (
    airnet as tairnet, capture, encoder_vit as tvit, uformer_lewin as tlewin)
from frequency_wised_all_in_one_image_restoration_model_tpu_torch.ops import (
    frequency as tfrequency)
from frequency_wised_all_in_one_image_restoration_model_tpu_torch.scripts import (
    plot_LFS_distribution as tlfs_cli)
from frequency_wised_all_in_one_image_restoration_model_tpu_torch.utils.weights import (
    from_jax)
from test_torch_airnet import P, tiny_cfg
from test_torch_backbones import VIT, tiny_cfg as backbone_cfg

TOL = 1e-5
GRAD_TOL = 1e-4
MASK_BAND = 1e-3


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(got, want, tol=TOL, what=""):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol,
                               err_msg=what)


# ---------------------------------------------------------------------------
# numpy modules, copied
# ---------------------------------------------------------------------------

RESULTS = ("101 Epochs Results:\n"
           "denoising_bsd68_15:        PSNR/SSIM: 30.12/0.8712\n"
           "deraining:                 PSNR/SSIM: 28.50/0.8301\n"
           "102 Epochs Results:\n"
           "denoising_bsd68_15:        PSNR/SSIM: 31.00/0.8800\n"
           "deraining:                 PSNR/SSIM: 29.00/0.8400\n"
           "103 Epochs Results:\n"
           "denoising_bsd68_15:        PSNR/SSIM: 31.00/0.8900\n"
           "deraining:                 PSNR/SSIM: 27.25/0.8100\n")


def test_performance_matches_jax(tmp_path):
    (tmp_path / "results.log").write_text(RESULTS)
    for i, psnr in ((100, 30.5), (200, 31.25)):
        (tmp_path / f"epoch_{i}_results.log").write_text(
            f"denoising_bsd68_15:   PSNR/SSIM: {psnr}/0.88\n"
            f"deraining:            PSNR/SSIM: {psnr - 2}/0.83\n")
    path = str(tmp_path / "results.log")
    got, want = tperf.parse_results_log(path, 2), jperf.parse_results_log(path, 2)
    assert got == want and len(got[0]) == 3
    for rows in got:
        assert tperf.best_k_summary(rows, top=2) == jperf.best_k_summary(rows, top=2)
    assert (tperf.parse_epoch_results(str(tmp_path), 200)
            == jperf.parse_epoch_results(str(tmp_path), 200) == [[30.5, 31.25],
                                                                 [28.5, 29.25]])


def test_frequency_dist_matches_jax(rng):
    imgs = [rng.uniform(0, 255, (32, 32, 3)) for _ in range(3)]
    np.testing.assert_array_equal(tfd.dataset_band_histogram(imgs, 0.1),
                                  jfd.dataset_band_histogram(imgs, 0.1))
    got = tfd.per_task_histograms({"a": imgs[:1], "b": imgs[1:]})
    want = jfd.per_task_histograms({"a": imgs[:1], "b": imgs[1:]})
    assert set(got) == set(want)
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])
    assert tfd.lfc_hfc(imgs[0]) == jfd.lfc_hfc(imgs[0])
    maps = rng.standard_normal((3, 1, 8, 8, 4))
    encode = lambda x: maps[int(x[0, 0, 0, 0])]
    ids = [np.full((8, 8, 3), i, np.float32) for i in range(3)]
    np.testing.assert_array_equal(tfd.latent_band_histogram(encode, ids),
                                  jfd.latent_band_histogram(encode, ids))


def test_tsne_matches_jax(rng):
    emb = rng.standard_normal((24, 8)).astype(np.float32)
    np.testing.assert_array_equal(temb.tsne_embed(emb, seed=3),
                                  jemb.tsne_embed(emb, seed=3))


def test_extract_lamb_matches_jax():
    """A tiny ViT with a DC ``lamb`` in each attention layer, drawn at
    random in the JAX tree and carried over."""
    cfg = backbone_cfg(encoder_type="ViT", decoder_type="ResNet",
                       frequency_decompose_type="DC", encoder_dim=None)
    x = np.random.default_rng(2).random((cfg.batch_size, P, P, 3), np.float32)
    jm = jvit.ViTEncoder(cfg=cfg, image_size=P, **VIT)
    v = jax.jit(lambda r, x: jm.init({"params": r, "dropout": r}, x,
                                     train=False))(jax.random.PRNGKey(0), x)
    draw = np.random.default_rng(3)
    params = jax.tree_util.tree_map_with_path(
        lambda path, leaf: (draw.standard_normal(leaf.shape).astype(np.float32)
                            if path[-1].key == "lamb" else np.asarray(leaf)),
        jax.device_get(v["params"]))
    tm = tvit.ViTEncoder(tconfig.from_fields(cfg), P, **VIT)
    tm.load_state_dict(from_jax({**v, "params": params}), strict=True)
    got = temb.extract_lamb_params(tm)
    want = jemb.extract_lamb_params(params)
    assert set(got) == set(want) and len(want) == VIT["depth"]
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    nested = temb.extract_lamb_params({"encoder": tm})
    assert set(nested) == {f"encoder/{k}" for k in want}


@pytest.mark.parametrize("shape,bands", [((2, 3, 16, 16), 5), ((1, 8, 12), 3)])
def test_visual_decompose_matches_jax(rng, shape, bands):
    """``frequency_decompose(inverse='visual')``, the shifted magnitude
    spectra the band energy sums."""
    x = rng.standard_normal(shape).astype(np.float32)
    got = tfrequency.frequency_decompose(torch.from_numpy(x), bands, "visual")
    want = jfrequency.frequency_decompose(jnp.asarray(x), bands, "visual")
    assert got.shape == (bands, *shape)
    _close(got, want)


@pytest.mark.parametrize("shape,bands", [((2, 3, 16, 16), 5),
                                         ((4, 1, 64, 64), 4),
                                         ((1, 2, 192, 192), 5)])
def test_attention_band_energy_matches_jax(rng, shape, bands):
    attn = rng.random(shape).astype(np.float32)
    attn /= attn.sum(-1, keepdims=True)
    got = tmsa.attention_band_energy(attn, bands)
    _close(got, jmsa.attention_band_energy(attn, bands))
    assert abs(got.sum() - 1.0) < 1e-6
    _close(tmsa.attention_band_energy(torch.from_numpy(attn), bands), got, 0)


@pytest.mark.parametrize("cutoff,reverse", [(0.065, False), (0.2, False),
                                            (0.1, True)])
def test_gaussian_filter_matches_jax(rng, cutoff, reverse):
    x = rng.random((2, 32, 32, 3)).astype(np.float32)
    got = tlfs.gaussian_filter_fft(torch.from_numpy(x), cutoff, reverse)
    assert got.dtype == torch.float32 and got.shape == x.shape
    _close(got, jlfs.gaussian_filter_fft(jnp.asarray(x), cutoff, reverse))


def test_channel_mask_matches_jax(rng):
    scores = {f"l{i}": rng.random(n).astype(np.float32)
              for i, n in enumerate((5, 17, 3))}
    for ratio in (0.0, 0.2, 0.5):
        (gm, gt), (wm, wt) = (tlfs.channel_mask(scores, ratio),
                              jlfs.channel_mask(scores, ratio))
        assert gt == wt and all(np.array_equal(gm[k], wm[k]) for k in scores)


# ---------------------------------------------------------------------------
# the tiny flagship: capture and LFS against JAX
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def flagship():
    cfg = tiny_cfg()
    rng = np.random.default_rng(11)
    x = rng.random((2, P, P, 3)).astype(np.float32)
    c = rng.random((2, P, P, 3)).astype(np.float32)
    jb = jairnet.build_models(cfg, eval_mode=True)
    enc_vars = jax.jit(lambda r, x: jb.encoder.init(
        {"params": r, "droppath": r}, x, train=False))(jax.random.PRNGKey(0), x)
    enc_cap = jax.jit(lambda v, x: jb.encoder.apply(
        v, x, train=False, mutable=["intermediates"]))
    (_, _, ctx), _ = enc_cap(enc_vars, x)
    dec_vars = jax.jit(lambda r, x, i: jb.decoder.init(
        {"params": r, "droppath": r}, x, i, train=False))(
            jax.random.PRNGKey(1), x, ctx)
    dec_cap = jax.jit(lambda v, x, i: jb.decoder.apply(
        v, x, i, train=False, mutable=["intermediates"]))
    apply = lambda fn: (lambda v, *a, mutable, train: fn(v, *a))
    enc_maps = jmsa.collect_attention_maps(apply(enc_cap), enc_vars, x,
                                           train=False)
    dec_maps = jmsa.collect_attention_maps(apply(dec_cap), dec_vars, x, ctx,
                                           train=False)
    lambs = jemb.embed_lamb_responses(apply(dec_cap), dec_vars, x, ctx)

    # the LFS objective of the root plot_LFS_distribution.py
    def restore_fn(params, xs):
        ev = {**enc_vars, "params": params["encoder"]}
        dv = {**dec_vars, "params": params["decoder"]}
        return jairnet.eval_forward(jb, ev, dv,
                                    jlfs.gaussian_filter_fft(xs, cutoff=0.2))

    def embed_fn(params, xs):
        ev = {**enc_vars, "params": params["encoder"]}
        return jb.encoder.apply(ev, xs, train=False)[1][0]

    params = {"encoder": enc_vars["params"], "decoder": dec_vars["params"]}
    batch = {"d1": x, "c1": c}
    teacher = jax.jit(embed_fn)(params, x)
    loss_fn = jlfs.distillation_loss_fn(restore_fn, embed_fn, teacher)
    # jlfs.lfs_gradients' mean of jax.grad over the batches, with the loss
    # from the same compiled step
    step = jax.jit(jax.value_and_grad(loss_fn))
    (loss, g1), (_, g2) = step(params, batch), step(params, batch)
    grads = jax.device_get(jax.tree_util.tree_map(lambda a, b: (a + b) / 2,
                                                  g1, g2))
    loss = float(loss)
    scores = jlfs.taylor_scores(jax.device_get(params), grads)
    masks, thresh = jlfs.channel_mask(scores, prune_ratio=0.2)

    enc_vars, dec_vars = jax.device_get((enc_vars, dec_vars))
    tb = tairnet.build_models(tconfig.from_fields(cfg), "cpu")
    tb.encoder.load_state_dict(from_jax(enc_vars), strict=True)
    tb.decoder.load_state_dict(from_jax(dec_vars), strict=True)
    return dict(x=x, batch=batch, bundle=tb, enc_maps=enc_maps,
                dec_maps=dec_maps, lambs=lambs, loss=loss, grads=grads,
                scores=scores, masks=masks, thresh=thresh)


def _blocks(module):
    return sum(isinstance(m, tlewin.LeWinBlock) for m in module.modules())


def _same_keys_close(got, want, tol=TOL):
    assert set(got) == set(want), sorted(set(got) ^ set(want))[:6]
    for k in want:
        assert got[k].shape == want[k].shape, k
        _close(got[k], want[k], tol, k)


def test_encoder_attention_maps_match_jax(flagship):
    """Every intra and inter map of the encoder, band-grouped
    ``[B', h, L*n, L*n]``."""
    tb = flagship["bundle"]
    got = tmsa.collect_attention_maps(tb.encoder.features, tb.encoder,
                                      torch.from_numpy(flagship["x"]))
    assert len(got) == 2 * _blocks(tb.encoder)
    assert all(v.shape[-1] == v.shape[-2] and v.shape[-1] % 3 == 0
               for v in got.values())
    _same_keys_close(got, flagship["enc_maps"])


def test_decoder_attention_maps_and_gains_match_jax(flagship):
    """The decoder's maps (all_DC: the unmodulated map) and its
    ``embed_lamb_1`` gains ``[B, 1, h]``."""
    tb, x = flagship["bundle"], torch.from_numpy(flagship["x"])
    with torch.no_grad():
        ctx = tb.encoder.features(x)
    got = tmsa.collect_attention_maps(tb.decoder, tb.decoder, x, ctx)
    assert len(got) == _blocks(tb.decoder)
    _same_keys_close(got, flagship["dec_maps"])
    lambs = temb.embed_lamb_responses(tb.decoder, x, ctx)
    assert all(v.shape[:2] == (2, 1) for v in lambs.values())
    _same_keys_close(lambs, flagship["lambs"])


def test_capture_changes_nothing_outside(flagship, monkeypatch):
    """A capture of the decoder leaves the encoder's blocks on their fused
    path inside the context, and every block on it after; the captured
    decoder's output equals the eval forward."""
    tb, x = flagship["bundle"], torch.from_numpy(flagship["x"])
    unfused = []
    orig = tlewin.LeWinBlock._forward_unfused
    monkeypatch.setattr(tlewin.LeWinBlock, "_forward_unfused",
                        lambda self, *a: unfused.append(self) or orig(self, *a))
    want = tairnet.eval_forward(tb, x)
    assert not unfused
    with torch.no_grad(), capture.capture(tb.decoder) as cap:
        ctx = tb.encoder.features(x)
        assert not unfused
        got = tb.decoder(x, ctx)
    n = _blocks(tb.decoder)
    assert len(unfused) == n and len(cap.named("attn_map")) == n
    _close(got, want)
    unfused.clear()
    _close(tairnet.eval_forward(tb, x), want, 0)
    assert not unfused and not capture._ACTIVE


def test_lfs_matches_jax(flagship):
    """The loss, every leaf's gradient, every leaf's Taylor scores and the
    masks against ``jax.grad`` of the root script's objective."""
    tb, batch = flagship["bundle"], flagship["batch"]
    out = tlfs_cli.lfs_analysis(tb, batch, [batch] * 2)
    assert abs(out["loss"] - flagship["loss"]) <= GRAD_TOL * max(
        1.0, abs(flagship["loss"]))
    want = {}
    for part in ("encoder", "decoder"):
        for k, v in from_jax({"params": flagship["grads"][part]}).items():
            want[f"{part}.{k}"] = v.numpy()
    assert set(out["grads"]) == set(want)
    rel = []
    for name, w in want.items():
        err = np.abs(out["grads"][name].numpy() - w).max()
        scale = np.abs(w).max()
        assert err <= GRAD_TOL * max(1.0, scale), (name, err)
        rel.append((err / scale if scale else 0.0, name))
    # beyond the bound: the decoder's gradients (the L1 term's) agree
    # relative to each leaf's own size. The encoder's, of 1e-9 and less,
    # are not held so: the KL term's vanishing gradient (R7) leaves both
    # sides with rounding noise of that size
    worst = max(r for r in rel if r[1].startswith("decoder."))
    assert worst[0] <= 1e-3, worst
    # JAX keys name a Dense / Conv kernel "kernel", the port "weight"
    jkey = lambda k: (k[:-len("weight")] + "kernel" if k.endswith("/weight")
                      and k[:-len("weight")] + "kernel" in flagship["scores"]
                      else k)
    scores = {jkey(k): v for k, v in out["scores"].items()}
    assert set(scores) == set(flagship["scores"])
    for k, w in flagship["scores"].items():
        assert scores[k].shape == w.shape, k
        err = np.abs(scores[k] - w).max()
        assert err <= GRAD_TOL * max(1.0, np.abs(w).max()), (k, err)
        if k.startswith("decoder/"):    # as the gradients above
            np.testing.assert_allclose(scores[k], w, rtol=3e-3,
                                       atol=1e-6 * np.abs(w).max(), err_msg=k)
    thresh = flagship["thresh"]
    assert abs(out["thresh"] - thresh) <= MASK_BAND * abs(thresh)
    for k, w in flagship["masks"].items():
        near = np.abs(flagship["scores"][k] - thresh) <= MASK_BAND * abs(thresh)
        differ = (out["masks"][{v: u for u, v in zip(out["scores"], scores)}[k]]
                  != w)
        assert not (differ & ~near).any(), k
