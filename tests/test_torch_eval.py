"""The port's eval entry point against the JAX package's: datasets, tiled
runner, result strings, results log, command line, checkpoints.

One module-scoped JAX ``init`` of the flagship configuration at P=32, width
4, ``uformer_depth_cap=1``, converted by ``from_jax``, serves every
comparison. Both runners get the SAME item list through ``dataset=``: the
synthetic test set seeds itself with ``hash(task)``, which is salted per
process, so two processes would not see the same images.

Tolerances: the result strings are equal; per image, PSNR within 1e-2 dB and
SSIM within 1e-4 (the two forwards agree to about 1e-5 per pixel in fp32);
restored images at other chunk sizes within 1e-6 (each tile is independent
of its batch, up to the matmul's blocking).
"""

import dataclasses
import importlib.util
import os
import subprocess
import sys
import zlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from frequency_wised_all_in_one_image_restoration_model_tpu import (
    config as jconfig)
from frequency_wised_all_in_one_image_restoration_model_tpu.data import (
    datasets as jdatasets, synthetic as jsynthetic)
from frequency_wised_all_in_one_image_restoration_model_tpu.evaluation import (
    runner as jrunner)
from frequency_wised_all_in_one_image_restoration_model_tpu.models import (
    airnet as jairnet)
from frequency_wised_all_in_one_image_restoration_model_tpu.utils import (
    logging as jlogging)
from frequency_wised_all_in_one_image_restoration_model_tpu_torch import (
    config as tconfig, test as ttest)
from frequency_wised_all_in_one_image_restoration_model_tpu_torch.data import (
    datasets as tdatasets, synthetic as tsynthetic)
from frequency_wised_all_in_one_image_restoration_model_tpu_torch.evaluation import (
    runner as trunner)
from frequency_wised_all_in_one_image_restoration_model_tpu_torch.models import (
    airnet as tairnet)
from frequency_wised_all_in_one_image_restoration_model_tpu_torch.training import (
    checkpoint as tckpt)
from frequency_wised_all_in_one_image_restoration_model_tpu_torch.utils import (
    logging as tlogging)
from frequency_wised_all_in_one_image_restoration_model_tpu_torch.utils.weights import (
    from_jax)

P = 32
TASK = "denoising_bsd68_25"
PSNR_TOL = 1e-2   # dB, per image
SSIM_TOL = 1e-4
CHUNK_TOL = 1e-6
REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def stable_task_hash(monkeypatch):
    """``SyntheticTestSet`` seeds itself with ``hash(task)``, salted per
    process: a module-level ``hash`` in both packages' ``data.synthetic``
    gives every run of these tests the same images (and the same digits in
    the result strings)."""
    for mod in (jsynthetic, tsynthetic):
        monkeypatch.setattr(mod, "hash", lambda s: zlib.crc32(s.encode()),
                            raising=False)


def tiny_cfg(**kw):
    base = dict(encoder_type="Uformer", decoder_type="Uformer",
                patch_size=P, crop_test_imgs_size=P, encoder_embed_dim=4,
                embed_dim=4, encoder_dim=8, de_type=["2tasks"], L=3,
                encoder_msa_type="freq",
                degradation_embedding_method=["all_DC"],
                uformer_depth_cap=1, remat=False, synthetic_data=True)
    base.update(kw)
    return jconfig.make_config(**base)


@pytest.fixture(scope="module")
def models():
    """JAX models with initialised variables, and the port's bundle holding
    the same weights."""
    cfg = tiny_cfg()
    x = np.random.default_rng(3).random((2, P, P, 3)).astype(np.float32)
    jb = jairnet.build_models(cfg, eval_mode=True)
    enc_vars = jax.jit(lambda r, x: jb.encoder.init(
        {"params": r, "droppath": r}, x, train=False))(
            jax.random.PRNGKey(0), x)
    _, _, ctx = jax.jit(lambda v, x: jb.encoder.apply(v, x, train=False))(
        enc_vars, x)
    dec_vars = jax.jit(lambda r, x, i: jb.decoder.init(
        {"params": r, "droppath": r}, x, i, train=False))(
            jax.random.PRNGKey(1), x, ctx)
    enc_vars, dec_vars = jax.device_get((enc_vars, dec_vars))
    tb = tairnet.build_models(tconfig.from_fields(cfg), "cpu")
    tb.encoder.load_state_dict(from_jax(enc_vars), strict=True)
    tb.decoder.load_state_dict(from_jax(dec_vars), strict=True)
    return dict(cfg=cfg, jb=jb, enc_vars=enc_vars, dec_vars=dec_vars, tb=tb,
                eval_fn=jrunner.make_eval_fn(jb))


def _items(cfg, task=TASK, n_images=3, image_size=72):
    """Three 64x64 images (after the crop to a multiple of 16): 4 tiles
    each, pooled into batches that chunk 3 cuts raggedly."""
    return list(jsynthetic.SyntheticTestSet(cfg, task, n_images=n_images,
                                            image_size=image_size, seed=0))


def test_test_by_task_matches_jax(models):
    cfg, tcfg = models["cfg"], models["tb"].cfg
    items = _items(cfg)
    want = jrunner.test_by_task(cfg, models["jb"], models["enc_vars"],
                                models["dec_vars"], TASK, epochs=1,
                                dataset=items, eval_fn=models["eval_fn"])
    got = trunner.test_by_task(tcfg, models["tb"], TASK, epochs=1,
                               dataset=items)
    assert got == want and got.startswith("PSNR/SSIM: ")


def test_per_image_metrics_match_jax(models):
    cfg = models["cfg"]
    items = _items(cfg)
    restored = list(trunner.restored_images(models["tb"].cfg, models["tb"],
                                            items))
    assert [n for n, _, _ in restored] == [n for n, _, _ in items]
    for (name, out, clean), (_, degraded, _) in zip(restored, items):
        want = jrunner.restore_image(models["eval_fn"], models["enc_vars"],
                                     models["dec_vars"], degraded, P)
        jp, js = jrunner._psnr_ssim_single(want, jnp.asarray(clean))
        tp, ts = trunner.psnr_ssim(out, clean)
        assert out.shape == clean.shape and out.dtype == torch.float32
        assert abs(tp - float(jp)) <= PSNR_TOL, name
        assert abs(ts - float(js)) <= SSIM_TOL, name


@pytest.mark.parametrize("chunk,pool", [(1, 4), (3, 4), (32, 1)])
def test_result_does_not_depend_on_the_chunk(models, chunk, pool):
    """Tiles are independent in eval: chunks of 1, a ragged 3, or no
    pooling give the images of the default (chunk 32, pools of 4)."""
    tb = models["tb"]
    items = _items(models["cfg"])
    want = list(trunner.restored_images(tb.cfg, tb, items))
    got = list(trunner.restored_images(tb.cfg, tb, items, pool_tiles=pool,
                                       chunk=chunk))
    for (n1, a, _), (n2, b, _) in zip(got, want):
        assert n1 == n2
        torch.testing.assert_close(a, b, rtol=0, atol=CHUNK_TOL)


def test_mixed_sizes_flush_per_shape(models):
    """Images with different tile grids are not pooled together, and come
    back in order at their own sizes."""
    cfg, tb = models["cfg"], models["tb"]
    items = _items(cfg, n_images=2) + _items(cfg, n_images=1, image_size=40)
    out = list(trunner.restored_images(tb.cfg, tb, items))
    assert [tuple(o.shape) for _, o, _ in out] == [(64, 64, 3), (64, 64, 3),
                                                   (32, 32, 3)]


def test_save_imgs_writes_the_same_files(models, tmp_path):
    items = _items(models["cfg"], n_images=2)
    names = {}
    for side in ("jax", "torch"):
        cfg = tiny_cfg(save_imgs=True, output_path=str(tmp_path / side) + "/")
        if side == "jax":
            jrunner.test_by_task(cfg, models["jb"], models["enc_vars"],
                                 models["dec_vars"], TASK, epochs=7,
                                 dataset=items, eval_fn=models["eval_fn"])
        else:
            trunner.test_by_task(tconfig.from_fields(cfg), models["tb"], TASK,
                                 epochs=7, dataset=items)
        d = tmp_path / side / "epoch_7_imgs" / f"test_{TASK}"
        names[side] = sorted(p.name for p in d.iterdir())
        imgs = [np.array(Image.open(d / n), np.int16) for n in names[side]]
        names[side + "_imgs"] = imgs
    assert names["jax"] == names["torch"] == [f"{TASK}_0.png", f"{TASK}_1.png"]
    for a, b in zip(names["jax_imgs"], names["torch_imgs"]):
        assert a.shape == b.shape and np.abs(a - b).max() <= 1  # uint8 rounding


def test_synthetic_test_set_matches_jax():
    cfg = tiny_cfg()
    for task in ("denoising_bsd68_50", "deraining", "dehazing", "deblurring"):
        want = list(jsynthetic.SyntheticTestSet(cfg, task, n_images=2,
                                                image_size=48, seed=1))
        got = list(tsynthetic.SyntheticTestSet(tconfig.from_fields(cfg), task,
                                               n_images=2, image_size=48,
                                               seed=1))
        assert len(got) == len(want) == 2
        for (n1, d1, c1), (n2, d2, c2) in zip(got, want):
            assert n1 == n2
            np.testing.assert_array_equal(d1, d2)
            np.testing.assert_array_equal(c1, c2)


@pytest.fixture
def png_tree(tmp_path, rng):
    """A tiny on-disk test tree: a denoising GT folder and a deraining
    Input / GT pair folder, odd sizes so the crop to 16 bites."""
    root = tmp_path / "data"
    files = {"denoising_bsd68_test/GT": ["a.png", "b.png"],
             "deraining_test/GT": ["rain-1.png", "rain-2.png"],
             "deraining_test/Input": ["rain-1_x.png", "rain-2_y.png"]}
    for folder, names in files.items():
        (root / folder).mkdir(parents=True)
        for name in names:
            arr = rng.integers(0, 256, (37, 50, 3), dtype=np.uint8)
            Image.fromarray(arr).save(root / folder / name)
    (root / "denoising_bsd68_test/Input").mkdir()
    return str(root) + "/"


@pytest.mark.parametrize("task", ["denoising_bsd68_15", "deraining"])
def test_file_test_dataset_matches_jax(png_tree, task):
    cfg = tiny_cfg(data_root=png_tree, synthetic_data=False)
    tcfg = tconfig.from_fields(cfg)
    assert tdatasets.task_test_dir(tcfg, task) == jdatasets.task_test_dir(
        cfg, task)
    d = tdatasets.task_test_dir(tcfg, task)
    assert tdatasets.get_data_ids(d, "denoising" in task) == \
        jdatasets.get_data_ids(d, "denoising" in task)
    for name in ("rain-1_x.png", "a.b_c.jpeg", "plain.png"):
        assert tdatasets.derive_gt_name(name) == jdatasets.derive_gt_name(name)
    want = list(jdatasets.FileTestDataset(cfg, task))
    got = list(trunner.build_test_dataset(tcfg, task))
    assert len(got) == len(want) == 2
    for (n1, d1, c1), (n2, d2, c2) in zip(got, want):
        assert n1 == n2 and d1.shape == (32, 48, 3)
        np.testing.assert_array_equal(d1, d2)   # the denoising draws too
        np.testing.assert_array_equal(c1, c2)


def test_file_test_dataset_rejects_sigma_zero(png_tree):
    cfg = tconfig.from_fields(tiny_cfg(data_root=png_tree))
    with pytest.raises(ValueError, match="sigma=0"):
        tdatasets.FileTestDataset(cfg, "denoising_bsd68_0")


def test_epoch_results_log_matches_jax(tmp_path):
    rows = [("denoising_bsd68_25", "PSNR/SSIM: 31.07/0.8812"),
            ("deraining", "PSNR/SSIM: 9.10/0.1000")]
    paths = []
    for side, mod, conf in (("j", jlogging, jconfig), ("t", tlogging, tconfig)):
        cfg = conf.make_config(output_path=str(tmp_path / side / "out") + "/")
        paths.append(Path(mod.write_epoch_results_log(cfg, 12, rows)))
    assert paths[0].name == paths[1].name == "epoch_12_results.log"
    assert paths[0].read_bytes() == paths[1].read_bytes()


def _flags(parser):
    return {a.dest: a for a in parser._actions if a.dest != "help"}


def test_parser_has_every_flag_of_the_jax_parser():
    want, got = _flags(jconfig.build_parser()), _flags(tconfig.build_parser())
    assert set(got) == set(want)
    for dest, a in want.items():
        b = got[dest]
        assert (b.option_strings, b.default, b.type, b.nargs, b.const) == \
            (a.option_strings, a.default, a.type, a.nargs, a.const), dest
        assert type(b) is type(a), dest


@pytest.mark.parametrize("argv", [
    [],
    ["--de_type", "3tasks", "--encoder_type", "ResNet"],
    ["--de_type", "2tasks", "--L", "2", "--output_path", "out/x/"],
    ["--save_imgs", "False", "--learnable_modulator", "", "--debug_mode", "0"],
    ["--test_de_type", "deraining", "dehazing", "--epochs", "7",
     "--degradation_embedding_method", "all_DC", "--synthetic_data",
     "--no_remat", "--cuda", "1", "--uformer_depth_cap", "2"],
])
def test_command_lines_parse_as_in_jax(argv):
    """Defaults, task shorthands, derived fields (batch_size, encoder_dim,
    lr, contrast_loss_weight, ckpt_path) and argparse's ``type=bool``
    (``--save_imgs False`` is true, an empty string false)."""
    want, got = jconfig.parse_args(argv), tconfig.parse_args(argv)
    for field in tconfig.FIELDS:
        assert getattr(got, field) == getattr(want, field), field
    assert got.ckpt_path == got.output_path + "ckpt/"


def test_parser_rejects_what_jax_rejects():
    for conf in (jconfig, tconfig):
        with pytest.raises(ValueError, match="encoder type"):
            conf.parse_args(["--encoder_type", "VGG"])
        with pytest.raises(ValueError, match="embedding method"):
            conf.parse_args(["--degradation_embedding_method", "all_x_bands"])


@pytest.mark.parametrize("overrides,item", [
    (dict(mesh_data=2), "item 10.8"),
    (dict(mesh_task=4), "item 10.8"),
])
def test_unported_values_name_their_roadmap_item(overrides, item):
    """The mesh flags pass the port's check; the ``model`` axis above 1
    (ROADMAP ``item``, ported) lays the flags' mesh out over two model
    indices in JAX's device order, and a size below 1 is refused; a mesh
    over which the global batch does not divide raises ValueError before
    any rank starts."""
    from frequency_wised_all_in_one_image_restoration_model_tpu_torch.parallel import (
        mesh as tmesh)

    cfg = tconfig.make_config(**{**dict(patch_size=P, crop_test_imgs_size=P,
                                        synthetic_data=True), **overrides})
    tconfig.check_ported(cfg)
    shape = (cfg.mesh_data, cfg.mesh_task, 2)
    layout = tmesh.make_mesh(*shape).mesh.numpy()
    np.testing.assert_array_equal(
        layout, np.arange(np.prod(shape)).reshape(shape), err_msg=item)
    with pytest.raises(ValueError):
        tmesh.make_mesh(cfg.mesh_data, cfg.mesh_task, n_model=0)
    odd = dataclasses.replace(cfg, mesh_task=3 * cfg.mesh_task)
    with pytest.raises(ValueError, match="not divisible"):
        ttest.main(odd, device="cpu")


def test_window_compat_is_checked_first():
    cfg = tconfig.make_config(patch_size=128, crop_test_imgs_size=32,
                              degradation_embedding_method=["all_DC"])
    with pytest.raises(ValueError, match="clamp"):
        ttest.main(cfg, device="cpu")


def test_main_without_a_card_raises(tmp_path):
    """No quiet CPU run: with no CUDA device the default device raises."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    cfg = tconfig.from_fields(tiny_cfg(output_path=str(tmp_path) + "/"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttest.main(cfg)
    assert not list(tmp_path.iterdir())


def test_main_builds_the_default_route(monkeypatch, tmp_path):
    """The entry point has no route option: ``main(cfg, device)`` leaves
    the blocks' route to ``build_models``, whose default is the route
    table of ``models/uformer_lewin.py``."""
    import inspect

    assert list(inspect.signature(ttest.main).parameters) == ["cfg", "device"]
    assert inspect.signature(
        tairnet.build_models).parameters["impl"].default == "default"
    seen = []

    def build(*args, **kwargs):
        seen.append((args, kwargs))
        raise KeyboardInterrupt

    monkeypatch.setattr(ttest, "build_models", build)
    cfg = tconfig.from_fields(tiny_cfg(output_path=str(tmp_path) + "/"))
    with pytest.raises(KeyboardInterrupt):
        ttest.main(cfg, device="cpu")
    assert seen == [((cfg, "cpu"), {})]


def _save_pt(models, ckpt_path, epoch):
    return tckpt.save_eval(ckpt_path, epoch, from_jax(models["enc_vars"]),
                           from_jax(models["dec_vars"]))


@pytest.mark.parametrize("have,asked,loaded", [(3, 3, 3), (5, 3, 5)])
def test_main_loads_the_checkpoint_and_logs_like_jax(models, tmp_path, capsys,
                                                     have, asked, loaded):
    """JAX init -> from_jax -> epoch_<N>.pt -> main on the CPU: the named
    epoch, or the newest when the named one is missing; the log equals the
    JAX runner's rows on the same weights and images."""
    out = str(tmp_path) + "/"
    # an explicit task list: a shorthand ("2tasks") would replace test_de_type
    cfg = tiny_cfg(output_path=out, epochs=asked, test_de_type=[TASK],
                   de_type=["denoising_0", "deraining"], seed=5)
    tcfg = tconfig.from_fields(cfg)
    assert tckpt.select_eval_epoch(tcfg.ckpt_path, asked) is None
    path = _save_pt(models, tcfg.ckpt_path, have)
    assert path.endswith(f"ckpt/epoch_{have}.pt") and tckpt.has_epoch(
        tcfg.ckpt_path, have)
    assert tckpt.select_eval_epoch(tcfg.ckpt_path, asked) == loaded
    assert tckpt.latest_epoch(tcfg.ckpt_path) == have

    rows = ttest.main(tcfg, device="cpu")
    printed = capsys.readouterr().out
    assert f"loaded checkpoint epoch_{loaded}" in printed
    assert ("falling back to latest epoch_5" in printed) == (have != asked)
    assert f"starting testing {TASK}..." in printed

    # same process, same hash salt: the JAX runner builds the same images
    want = jrunner.test_by_task(cfg, models["jb"], models["enc_vars"],
                                models["dec_vars"], TASK, epochs=asked,
                                eval_fn=models["eval_fn"])
    assert rows == [(TASK, want)]
    log = Path(out) / f"epoch_{asked}_results.log"
    jcfg_out = tiny_cfg(output_path=str(tmp_path / "j") + "/")
    jlog = Path(jlogging.write_epoch_results_log(jcfg_out, asked,
                                                 [(TASK, want)]))
    assert log.read_bytes() == jlog.read_bytes()


def test_main_without_checkpoint_runs_on_seed_weights(tmp_path, capsys):
    cfg = tconfig.from_fields(tiny_cfg(
        output_path=str(tmp_path) + "/", epochs=2, test_de_type=["deraining"],
        de_type=["denoising_0", "deraining"]))
    rows = ttest.main(cfg, device="cpu")
    assert "loaded checkpoint" not in capsys.readouterr().out
    assert rows[0][0] == "deraining" and rows[0][1].startswith("PSNR/SSIM: ")
    assert (tmp_path / "epoch_2_results.log").read_text() == \
        "deraining: " + " " * 16 + rows[0][1] + "\n"


def test_restore_eval_is_strict(models, tmp_path):
    path = _save_pt(models, str(tmp_path), 1)
    state = torch.load(path, weights_only=True)
    assert set(state) == {"encoder", "decoder"}
    state["decoder"].pop(next(iter(state["decoder"])))
    torch.save(state, path)
    with pytest.raises(RuntimeError, match="Missing key"):
        tckpt.restore_eval(str(tmp_path), 1, models["tb"])


def test_orbax_checkpoint_converts_to_pt(models, tmp_path):
    """tools/jax_ckpt_to_torch.py: an Orbax ``epoch_4`` of the JAX package
    -> ``epoch_4.pt`` that the port loads, weights equal."""
    from frequency_wised_all_in_one_image_restoration_model_tpu.training import (
        checkpoint as jckpt)
    from frequency_wised_all_in_one_image_restoration_model_tpu.training.state import (
        TrainState)

    spec = importlib.util.spec_from_file_location(
        "jax_ckpt_to_torch", REPO / "tools" / "jax_ckpt_to_torch.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)

    split = lambda v: ({k: x for k, x in v.items() if k == "params"}["params"],
                       {k: x for k, x in v.items() if k != "params"})
    (ep, ee), (dp, de) = split(models["enc_vars"]), split(models["dec_vars"])
    state = TrainState(step=np.zeros((), np.int32),
                       params={"encoder": ep, "decoder": dp},
                       extra={"encoder": ee, "decoder": de},
                       moco={"queue": np.zeros((2, 3), np.float32)},
                       opt_state={"count": np.zeros((), np.int32)},
                       rng=np.zeros((2,), np.uint32))
    ckpt_path = str(tmp_path / "ckpt")
    jckpt.save(ckpt_path, 4, state)
    assert tool.main(["--ckpt_path", ckpt_path, "--epoch", "4"]) == 0

    bundle = tairnet.build_models(models["tb"].cfg, "cpu")
    tckpt.restore_eval(ckpt_path, 4, bundle)
    for got, want in ((bundle.encoder, models["tb"].encoder),
                      (bundle.decoder, models["tb"].decoder)):
        want_sd = want.state_dict()
        for k, v in got.state_dict().items():
            torch.testing.assert_close(v, want_sd[k], rtol=0, atol=0)


def test_cli_runs_as_a_module_and_needs_a_card(tmp_path):
    """``python -m <port>.test`` parses the flags and, on a host without a
    card, fails with the device error instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    env = dict(os.environ, PYTHONPATH=str(REPO), PYTHONHASHSEED="0")
    r = subprocess.run(
        [sys.executable, "-m",
         "frequency_wised_all_in_one_image_restoration_model_tpu_torch.test",
         "--synthetic_data", "--degradation_embedding_method", "all_DC",
         "--patch_size", "32", "--crop_test_imgs_size", "32",
         "--output_path", str(tmp_path) + "/"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and "no CUDA device" in r.stderr
    assert not list(tmp_path.iterdir())


def test_every_port_module_imports_without_jax(tmp_path):
    """Every module of the port imports, and the eval entry point runs on
    the CPU, with jax, flax, orbax and the JAX package blocked."""
    code = """
import importlib, pkgutil, sys

BLOCKED = ("jax", "jaxlib", "flax", "orbax", "optax",
           "frequency_wised_all_in_one_image_restoration_model_tpu")

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked: {name}")
        return None

sys.meta_path.insert(0, Block())
import frequency_wised_all_in_one_image_restoration_model_tpu_torch as port
names = [m.name for m in pkgutil.walk_packages(port.__path__, port.__name__ + ".")]
for name in names:
    importlib.import_module(name)
assert len(names) >= 25, names
from frequency_wised_all_in_one_image_restoration_model_tpu_torch import config, test
cfg = config.parse_args(
    ["--synthetic_data", "--degradation_embedding_method", "all_DC",
     "--patch_size", "32", "--crop_test_imgs_size", "32", "--embed_dim", "4",
     "--encoder_embed_dim", "4", "--encoder_dim", "8", "--uformer_depth_cap",
     "1", "--test_de_type", "dehazing", "--output_path", sys.argv[1]])
rows = test.main(cfg, device="cpu")
assert rows[0][0] == "dehazing"
assert not any(m.split(".")[0] in BLOCKED for m in sys.modules)
print("ok", len(names))
"""
    env = dict(os.environ, PYTHONPATH=str(REPO), PYTHONHASHSEED="0")
    r = subprocess.run([sys.executable, "-c", code, str(tmp_path) + "/"],
                       cwd=REPO, env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().splitlines()[-1].startswith("ok")
    assert (tmp_path / "epoch_1000_results.log").exists()
