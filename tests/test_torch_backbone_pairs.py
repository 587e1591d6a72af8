"""The whole eval forward of the port's new encoder / decoder pairs against
the JAX package's, on the CPU: ``resnet_dgrn`` and ``vit_freq`` (the JAX
package's parity configurations), the ResNet encoder behind the Uformer
decoder and the origin-MSA L = 1 Uformer encoder behind it, at the widths
of ``test_torch_backbones.py``, whose helpers this file shares; and
``test.main`` for ResNet + DGRN against the JAX runner. (The tiny flagship
by the ``'split'`` route is in ``test_torch_airnet.py``.) Weights from JAX ``init`` (offset heads and ``lamb`` made
live) through ``from_jax``; the forward within 1e-4 of JAX, the default and
the plain route within 1e-6 of each other.
"""

import dataclasses
import functools

import pytest
import torch

from frequency_wised_all_in_one_image_restoration_model_tpu.models import (
    airnet as jairnet)
from frequency_wised_all_in_one_image_restoration_model_tpu_torch import (
    config as tconfig)
from frequency_wised_all_in_one_image_restoration_model_tpu_torch.models import (
    airnet as tairnet, encoder_vit as tvit, uformer_lewin)
from frequency_wised_all_in_one_image_restoration_model_tpu_torch.models.encoder_uformer import (
    DegradationContext)
from frequency_wised_all_in_one_image_restoration_model_tpu_torch.utils.weights import (
    from_jax)
from test_torch_backbones import (P, TOL_MODEL, VIT, _close, _jax_forward,
                                  _load, _x, tiny_cfg)

# the model families of the JAX package's parity configs
# (tools/parity_train.py:77-86) and the new encoders behind the Uformer
# decoder, at tiny widths
PAIRS = {
    "resnet_dgrn": dict(encoder_type="ResNet", decoder_type="ResNet",
                        encoder_dim=16),
    "vit_freq": dict(encoder_type="ViT", decoder_type="ResNet",
                     frequency_decompose_type="DC"),
    "resnet_uformer": dict(encoder_type="ResNet", decoder_type="Uformer",
                           encoder_dim=16),
    "origin_l1_uformer": dict(encoder_type="Uformer", decoder_type="Uformer",
                              encoder_msa_type="origin", L=1,
                              degradation_embedding_method=["residual"]),
}


def _port_bundle(cfg, enc, dec, impl="default", vit=None):
    tb = tairnet.build_models(tconfig.from_fields(cfg), "cpu", impl=impl)
    if vit:
        tb = dataclasses.replace(tb, encoder=tvit.ViTEncoder(
            tb.cfg, P, **vit).eval())
    _load(tb.encoder, enc)
    _load(tb.decoder, dec)
    return tb


@functools.lru_cache(maxsize=None)
def _pair_run(name):
    """JAX's side of a pair, made once per process."""
    cfg = tiny_cfg(**PAIRS[name])
    vit = VIT if cfg.encoder_type == "ViT" else None
    x = _x(5)
    jb, enc, dec, (out, inter), y = _jax_forward(cfg, x, vit)
    return dict(name=name, cfg=cfg, x=x, vit=vit, jb=jb, enc=enc, dec=dec,
                out=out, inter=inter, y=y)


@pytest.fixture(scope="module", params=list(PAIRS))
def pair(request):
    run = _pair_run(request.param)
    return dict(run, bundle=_port_bundle(run["cfg"], run["enc"], run["dec"],
                                         vit=run["vit"]))


def test_pair_eval_forward_matches_jax(pair):
    """The whole eval forward by the default and by the plain route, and
    the bundle's glue: the loss count and the device."""
    tb, x = pair["bundle"], torch.from_numpy(pair["x"])
    got = tairnet.eval_forward(tb, x)
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, P, P, 3)
    _close(got, pair["y"], TOL_MODEL, pair["name"])
    plain = _port_bundle(pair["cfg"], pair["enc"], pair["dec"], "plain",
                         pair["vit"])
    _close(tairnet.eval_forward(plain, x), got.numpy(), 1e-6)
    cfg = pair["cfg"]
    assert tb.num_losses == jairnet.effective_num_losses(cfg)
    assert tb.device == torch.device("cpu")
    routes = {m.route(torch.float32, 2) for m in tb.decoder.modules()
              if isinstance(m, uformer_lewin.LeWinBlock)}
    assert routes <= {"kernel"}


def test_pair_encoder_outputs_match_jax(pair):
    """The encoder's contrastive output and its conditioning: the spatial
    map of ResNet / ViT, the context of the Uformer encoder (L = 1: the
    bottleneck and every stage's output)."""
    tb = pair["bundle"]
    with torch.no_grad():
        _, out, inter = tb.encoder(torch.from_numpy(pair["x"]))
    _close(out, pair["out"], TOL_MODEL, pair["name"])
    if isinstance(inter, DegradationContext):
        want = pair["inter"]
        assert len(inter.band_inter) == pair["cfg"].L
        assert len(inter.pyramid) == 5
        for g, w in zip(inter.band_inter + inter.pyramid,
                        want.band_inter + want.pyramid):
            _close(g, w, TOL_MODEL)
    else:
        _close(inter, pair["inter"], TOL_MODEL, pair["name"])


def test_main_resnet_dgrn_matches_jax_runner(tmp_path, monkeypatch):
    """``test.main(cfg, device="cpu")`` for ResNet + DGRN from a checkpoint
    of JAX weights: the result strings equal the JAX runner's on the same
    weights and images (``hash`` pinned in both packages, as
    ``test_torch_eval.py`` does); the JAX weights of the pair's run."""
    import zlib

    from frequency_wised_all_in_one_image_restoration_model_tpu.data import (
        synthetic as jsynthetic)
    from frequency_wised_all_in_one_image_restoration_model_tpu.evaluation import (
        runner as jrunner)
    from frequency_wised_all_in_one_image_restoration_model_tpu_torch import (
        test as ttest)
    from frequency_wised_all_in_one_image_restoration_model_tpu_torch.data import (
        synthetic as tsynthetic)
    from frequency_wised_all_in_one_image_restoration_model_tpu_torch.training import (
        checkpoint as tckpt)

    for mod in (jsynthetic, tsynthetic):
        monkeypatch.setattr(mod, "hash", lambda s: zlib.crc32(s.encode()),
                            raising=False)
    task = "denoising_bsd68_25"
    run = _pair_run("resnet_dgrn")
    jb, enc, dec = run["jb"], run["enc"], run["dec"]
    cfg = tiny_cfg(**PAIRS["resnet_dgrn"], output_path=str(tmp_path) + "/",
                   epochs=2, test_de_type=[task], synthetic_data=True,
                   de_type=["denoising_0", "deraining"])
    tcfg = tconfig.from_fields(cfg)
    tckpt.save_eval(tcfg.ckpt_path, 2, from_jax(enc), from_jax(dec))
    rows = ttest.main(tcfg, device="cpu")
    want = jrunner.test_by_task(cfg, jb, enc, dec, task, epochs=2,
                                eval_fn=jrunner.make_eval_fn(jb))
    assert rows == [(task, want)]
