"""The port's whole slice against the JAX package: the flagship
configuration (Uformer encoder with L=3 bands and frequency-wise MSA,
Uformer decoder with all_DC) at P=32, width 4, ``uformer_depth_cap=2``
(cap 2 keeps the shifted blocks), with the JAX ``init`` converted by
``from_jax``. One module-scoped JAX run serves every comparison; its input
is the tile batch of one image, so the stitch is compared too."""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from frequency_wised_all_in_one_image_restoration_model_tpu import config
from frequency_wised_all_in_one_image_restoration_model_tpu.evaluation import (
    tiling as jtiling)
from frequency_wised_all_in_one_image_restoration_model_tpu.models import (
    airnet as jairnet)
from frequency_wised_all_in_one_image_restoration_model_tpu_torch import (
    config as tconfig, serving as tserving)
from frequency_wised_all_in_one_image_restoration_model_tpu_torch.evaluation import (
    tiling as ttiling)
from frequency_wised_all_in_one_image_restoration_model_tpu_torch.models import (
    airnet as tairnet)
from frequency_wised_all_in_one_image_restoration_model_tpu_torch.utils.weights import (
    from_jax)

P = 32
IMG_HW = (40, 56)   # 2 x 2 real tiles of 32, padded to a batch of 8
TOL_MODULE = 1e-5
TOL_MODEL = 1e-4
REPO = Path(__file__).resolve().parents[1]


def tiny_cfg(**kw):
    base = dict(encoder_type="Uformer", decoder_type="Uformer",
                patch_size=P, crop_test_imgs_size=P, encoder_embed_dim=4,
                embed_dim=4, encoder_dim=8, de_type=["2tasks"], L=3,
                encoder_msa_type="freq",
                degradation_embedding_method=["all_DC"],
                uformer_depth_cap=2, remat=False)
    base.update(kw)
    return config.make_config(**base)


@pytest.fixture(scope="module")
def slice_run():
    cfg = tiny_cfg()
    img = np.random.default_rng(7).random((*IMG_HW, 3)).astype(np.float32)
    tiles, offsets, n = jtiling.extract_tiles(img, P)
    jb = jairnet.build_models(cfg, eval_mode=True)
    enc_vars = jax.jit(lambda r, x: jb.encoder.init(
        {"params": r, "droppath": r}, x, train=False))(
            jax.random.PRNGKey(0), tiles)
    _, out, ctx = jax.jit(lambda v, x: jb.encoder.apply(v, x, train=False))(
        enc_vars, tiles)
    dec_vars = jax.jit(lambda r, x, i: jb.decoder.init(
        {"params": r, "droppath": r}, x, i, train=False))(
            jax.random.PRNGKey(1), tiles, ctx)
    y = jax.jit(lambda e, d, x: jairnet.eval_forward(jb, e, d, x))(
        enc_vars, dec_vars, tiles)
    stitched = jtiling.stitch_tiles(y, offsets, n, *IMG_HW)

    enc_vars, dec_vars = jax.device_get((enc_vars, dec_vars))
    tb = tairnet.build_models(tconfig.from_fields(cfg), "cpu")
    tb.encoder.load_state_dict(from_jax(enc_vars), strict=True)
    tb.decoder.load_state_dict(from_jax(dec_vars), strict=True)
    return dict(cfg=cfg, img=img, tiles=tiles, offsets=offsets, n=n,
                enc_vars=enc_vars, dec_vars=dec_vars, bundle=tb,
                out=np.array(out),
                band_inter=[np.array(b) for b in ctx.band_inter],
                y=np.array(y), stitched=np.array(stitched))


def _leaves(tree):
    return len(jax.tree_util.tree_leaves(tree))


def test_from_jax_covers_every_leaf(slice_run):
    """Every JAX leaf lands in the state_dict (strict load passed in the
    fixture); BatchNorm adds its num_batches_tracked counter."""
    enc, dec = slice_run["enc_vars"], slice_run["dec_vars"]
    n_bn = len(enc["batch_stats"])
    assert len(from_jax(enc)) == _leaves(enc) + n_bn
    assert len(from_jax(dec)) == _leaves(dec)
    b = slice_run["bundle"]
    assert set(from_jax(enc)) == set(b.encoder.state_dict())
    assert set(from_jax(dec)) == set(b.decoder.state_dict())


@pytest.mark.parametrize("band", [0, 1, 2])
def test_encoder_band_features_match(slice_run, band):
    ctx = slice_run["bundle"].encoder.features(torch.from_numpy(slice_run["tiles"]))
    np.testing.assert_allclose(ctx.band_inter[band].detach().numpy(),
                               slice_run["band_inter"][band],
                               rtol=TOL_MODULE, atol=TOL_MODULE)


def test_encoder_heads_match(slice_run):
    with torch.no_grad():
        fea, out, _ = slice_run["bundle"].encoder(
            torch.from_numpy(slice_run["tiles"]))
    assert fea is None and tuple(out.shape) == (3, 8, 8)
    np.testing.assert_allclose(out.numpy(), slice_run["out"],
                               rtol=TOL_MODULE, atol=TOL_MODULE)


def test_eval_forward_matches(slice_run):
    got = tairnet.eval_forward(slice_run["bundle"],
                               torch.from_numpy(slice_run["tiles"]))
    assert got.dtype == torch.float32 and tuple(got.shape) == (8, P, P, 3)
    np.testing.assert_allclose(got.numpy(), slice_run["y"],
                               rtol=TOL_MODEL, atol=TOL_MODEL)


def test_split_route_matches_jax(slice_run):
    """``impl='split'``: every decoder block through the split kernels'
    plain versions (K12 / K13's functions) gives JAX's forward too."""
    tb = tairnet.build_models(tconfig.from_fields(slice_run["cfg"]), "cpu",
                              impl="split")
    tb.encoder.load_state_dict(from_jax(slice_run["enc_vars"]), strict=True)
    tb.decoder.load_state_dict(from_jax(slice_run["dec_vars"]), strict=True)
    blocks = [m for m in tb.decoder.modules() if hasattr(m, "route")]
    assert blocks and {m.route(torch.float32, 8) for m in blocks} == {"split"}
    got = tairnet.eval_forward(tb, torch.from_numpy(slice_run["tiles"]))
    np.testing.assert_allclose(got.numpy(), slice_run["y"],
                               rtol=TOL_MODEL, atol=TOL_MODEL)


def test_served_forward_matches_jax(slice_run):
    """The serving export of the slice (``serving.export_eval``, the plain
    route on the CPU, weights from ``from_jax``) against JAX's forward on
    the tile batch, and a short batch padded and cropped."""
    tcfg = tconfig.from_fields(slice_run["cfg"])
    states = (from_jax(slice_run["enc_vars"]), from_jax(slice_run["dec_vars"]))
    tiles = slice_run["tiles"]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        model = tserving.loads(tserving.export_eval(
            tcfg, states, batch=len(tiles), device="cpu"))
        got, short = model(tiles), model(tiles[:3])
    finally:
        torch.set_num_threads(threads)
    assert model.meta["encoder_type"] == model.meta["decoder_type"] == "Uformer"
    np.testing.assert_allclose(got.numpy(), slice_run["y"], rtol=TOL_MODEL,
                               atol=TOL_MODEL)
    np.testing.assert_allclose(short.numpy(), slice_run["y"][:3],
                               rtol=TOL_MODEL, atol=TOL_MODEL)


def test_stitch_tiles_matches(slice_run):
    got = ttiling.stitch_tiles(torch.from_numpy(slice_run["y"]),
                               slice_run["offsets"], slice_run["n"], *IMG_HW)
    np.testing.assert_allclose(got.numpy(), slice_run["stitched"],
                               rtol=TOL_MODULE, atol=TOL_MODULE)


def test_restore_image_matches(slice_run):
    got = ttiling.restore_image(slice_run["bundle"], slice_run["img"],
                                chunk=3)
    assert tuple(got.shape) == (*IMG_HW, 3)
    np.testing.assert_allclose(got.numpy(), slice_run["stitched"],
                               rtol=TOL_MODEL, atol=TOL_MODEL)


def test_tile_layout_matches():
    img = np.zeros((70, 33, 3), np.float32)
    got, want = ttiling.extract_tiles(img, P), jtiling.extract_tiles(img, P)
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2] and got[0].shape == want[0].shape


@pytest.mark.parametrize("field,value", [
    ("mesh_data", 2),
    ("mesh_task", 4),
])
def test_unported_options_raise(field, value):
    """A mesh builds now (one rank a card): mesh_data 2 passes; mesh_task 4
    does not divide this global batch of 2 and raises ValueError, as JAX's
    ``process_slice``; a ``model`` axis of 2 over the flags' mesh is laid
    out in JAX's device order, one of 0 refused."""
    from frequency_wised_all_in_one_image_restoration_model_tpu_torch.parallel import (
        mesh as tmesh)

    cfg = tconfig.from_fields(tiny_cfg(**{field: value}))
    if (cfg.mesh_data * cfg.batch_size) % (cfg.mesh_data * cfg.mesh_task):
        with pytest.raises(ValueError, match="not divisible"):
            tairnet.build_models(cfg, "cpu")
    else:
        tairnet.build_models(cfg, "cpu")
    shape = (cfg.mesh_data, cfg.mesh_task, 2)
    np.testing.assert_array_equal(tmesh.make_mesh(*shape).mesh.numpy(),
                                  np.arange(np.prod(shape)).reshape(shape))
    with pytest.raises(ValueError):
        tmesh.make_mesh(cfg.mesh_data, cfg.mesh_task, n_model=0)


@pytest.mark.parametrize("field", tconfig.FIELDS)
def test_config_defaults_match(field):
    """The port's config fields carry the JAX CLI's names, defaults and
    derivations (``encoder_dim`` from the encoder type)."""
    # the CLI's defaults: tests/conftest.py turns remat off in make_config
    want = getattr(config.parse_args([]), field)
    assert getattr(tconfig.make_config(), field) == want
    jcfg = tiny_cfg(encoder_dim=None)
    assert getattr(tconfig.from_fields(jcfg), field) == getattr(jcfg, field)


def test_config_rejects_unknown_fields():
    with pytest.raises(AttributeError, match="no_such_field"):
        tconfig.make_config(no_such_field=["4tasks"])


def test_port_runs_without_jax():
    """Import the port and run the tiny forward with jax, flax and the JAX
    package blocked."""
    code = textwrap.dedent("""
        import sys

        BLOCKED = ("jax", "jaxlib", "flax",
                   "frequency_wised_all_in_one_image_restoration_model_tpu")

        class Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in BLOCKED:
                    raise ImportError(f"blocked: {name}")
                return None

        sys.meta_path.insert(0, Block())
        import torch
        from frequency_wised_all_in_one_image_restoration_model_tpu_torch import config
        from frequency_wised_all_in_one_image_restoration_model_tpu_torch.models import airnet
        from frequency_wised_all_in_one_image_restoration_model_tpu_torch.evaluation import tiling
        cfg = config.make_config(
            patch_size=32, encoder_embed_dim=4,
            embed_dim=4, encoder_dim=8, L=3, encoder_msa_type="freq",
            degradation_embedding_method=["all_DC"], uformer_depth_cap=1)
        bundle = airnet.build_models(cfg, "cpu")
        y = airnet.eval_forward(bundle, torch.rand(2, 32, 32, 3))
        assert y.shape == (2, 32, 32, 3) and torch.isfinite(y).all()
        assert not any(m.split(".")[0] in BLOCKED for m in sys.modules)
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().endswith("ok")
