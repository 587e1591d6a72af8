"""The port's serving export (``serving.py``) on the CPU against the JAX
package's: the tiny ResNet + DGRN of the JAX ``tests/test_serving.py``,
JAX ``init`` -> ``from_jax`` -> ``export_eval(..., device="cpu")`` (the
plain route), the served output held to JAX's ``eval_forward`` at JAX's
serving tolerance (rtol = atol = 1e-5), the full and a partial batch; the
shape errors; the artifact loaded in a process that imports no model code,
its metadata, the weights stored once; each package refusing the other's
artifact; the CLI. (The tiny flagship's served forward is in
``test_torch_airnet.py``, on that file's JAX run.)
"""

import json
import os
import struct
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from frequency_wised_all_in_one_image_restoration_model_tpu import (
    config, serving as jserving)
from frequency_wised_all_in_one_image_restoration_model_tpu.models.airnet import (
    build_models, eval_forward)
from frequency_wised_all_in_one_image_restoration_model_tpu_torch import (
    config as tconfig, export_serving, serving)
from frequency_wised_all_in_one_image_restoration_model_tpu_torch.models import (
    airnet as tairnet)
from frequency_wised_all_in_one_image_restoration_model_tpu_torch.ops.kernels import (
    custom_ops)
from frequency_wised_all_in_one_image_restoration_model_tpu_torch.utils.weights import (
    from_jax)

PORT = "frequency_wised_all_in_one_image_restoration_model_tpu_torch"
REPO = Path(__file__).resolve().parents[1]
TOL = 1e-5          # JAX's tests/test_serving.py
BATCH = 4


def _tiny_cfg():
    """JAX ``tests/test_serving.py``'s configuration."""
    return config.make_config(
        synthetic_data=True, de_type=["deraining"],
        test_de_type=["deraining"], encoder_type="ResNet",
        decoder_type="ResNet", encoder_dim=16, dgrn_groups=1,
        dgrn_blocks=1, patch_size=32, crop_test_imgs_size=32,
        dtype="float32")


@pytest.fixture(scope="module", autouse=True)
def single_threaded():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def served():
    """JAX's init and forward of the tiny pair, and the port's artifact of
    the same weights."""
    cfg = _tiny_cfg()
    jb = build_models(cfg, eval_mode=True)
    x = np.random.default_rng(0).uniform(0, 1, (BATCH, 32, 32, 3)).astype(
        np.float32)
    rng = jax.random.PRNGKey(0)
    enc_vars = jax.jit(lambda r, x: jb.encoder.init(
        {"params": r, "droppath": r}, x, train=False))(rng, x[:1])
    _, _, inter = jax.jit(lambda v, x: jb.encoder.apply(
        v, x, train=False))(enc_vars, x[:1])
    dec_vars = jax.jit(lambda r, x, i: jb.decoder.init(
        {"params": r, "droppath": r}, x, i, train=False))(
            jax.random.PRNGKey(1), x[:1], inter)
    want = np.asarray(jax.jit(lambda e, d, x: eval_forward(jb, e, d, x))(
        enc_vars, dec_vars, x))
    enc_vars, dec_vars = jax.device_get((enc_vars, dec_vars))
    states = (from_jax(enc_vars), from_jax(dec_vars))
    tcfg = tconfig.from_fields(cfg)
    blob = serving.export_eval(tcfg, states, batch=BATCH, device="cpu")
    return dict(cfg=cfg, tcfg=tcfg, x=x, want=want, blob=blob,
                states=states, enc_vars=enc_vars, dec_vars=dec_vars)


def test_served_matches_jax(served, tmp_path):
    path = str(tmp_path / "model.fairm")
    serving.save(path, served["blob"])
    model = serving.load(path)
    assert model.input_shape == (BATCH, 32, 32, 3)
    got = model(served["x"])
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), served["want"], rtol=TOL, atol=TOL)


def test_partial_batch_pads_and_crops(served):
    """A short batch is zero-padded to the exported batch, and the pad rows
    are dropped from the output; tiles may be a tensor."""
    model = serving.loads(served["blob"])
    got = model(torch.from_numpy(served["x"][:2]))
    assert tuple(got.shape) == (2, 32, 32, 3)
    np.testing.assert_allclose(got.numpy(), served["want"][:2], rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("shape", [(1, 16, 16, 3), (BATCH + 1, 32, 32, 3),
                                   (32, 32, 3)],
                         ids=["tile size", "batch over the exported",
                              "no batch axis"])
def test_shape_errors(served, shape):
    model = serving.loads(served["blob"])
    with pytest.raises(ValueError):
        model(np.zeros(shape, np.float32))


def test_matches_the_eager_port(served):
    """The served program computes the eager plain route bit for bit."""
    tb = tairnet.build_models(served["tcfg"], "cpu")
    tb.encoder.load_state_dict(served["states"][0], strict=True)
    tb.decoder.load_state_dict(served["states"][1], strict=True)
    x = torch.from_numpy(served["x"])
    assert torch.equal(serving.loads(served["blob"])(x),
                       tairnet.eval_forward(tb, x))


def test_metadata(served):
    meta = serving.loads(served["blob"]).meta
    enc, dec = served["states"]
    assert meta["input_shape"] == [BATCH, 32, 32, 3]
    assert meta["input_dtype"] == "float32" and meta["device"] == "cpu"
    assert meta["encoder_type"] == "ResNet" and meta["decoder_type"] == "ResNet"
    assert meta["eval_dtype"] == "float32"
    assert meta["enc_paths"] == list(enc) and meta["dec_paths"] == list(dec)
    # the plain route: no kernel, no operands' program
    assert meta["launches"] == {} and meta["operands"] == 0
    assert meta["programs"]["operands"] == 0
    assert meta["kernels"] == serving.build.source_hash()
    assert meta["torch_version"] == torch.__version__


def test_weights_stored_once(served):
    """The artifact is its header, metadata, the weights' .npz and the
    program, which does not hold the weights again (it is saved without its
    example inputs): the whole is under the .npz plus 2 MiB."""
    blob = served["blob"]
    mlen = struct.unpack("<II", blob[8:16])[1]
    meta = json.loads(blob[16:16 + mlen])
    assert len(blob) == (16 + mlen + meta["weights_len"]
                         + meta["programs"]["forward"])
    n_weights = sum(v.numel() * v.element_size()
                    for s in served["states"] for v in s.values())
    assert meta["weights_len"] >= n_weights
    assert len(blob) < meta["weights_len"] + 2 * 2 ** 20


def test_loads_without_model_code(served, tmp_path):
    """A fresh process loads and runs the artifact importing the port's
    ``serving`` (and through it the kernels' registrations) only: no model,
    no configuration module."""
    path = tmp_path / "model.fairm"
    serving.save(str(path), served["blob"])
    np.save(tmp_path / "x.npy", served["x"])
    code = textwrap.dedent(f"""
        import sys
        import numpy as np
        from {PORT} import serving
        model = serving.load(sys.argv[1])
        out = model(np.load(sys.argv[2])).numpy()
        np.save(sys.argv[3], out)
        loaded = sorted(m for m in sys.modules if m.startswith("{PORT}."))
        bad = [m for m in loaded if m.startswith(("{PORT}.models",
                                                  "{PORT}.config"))]
        assert not bad, bad
        print("ok", model.meta["encoder_type"], len(loaded))
    """)
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-c", code, str(path),
                        str(tmp_path / "x.npy"), str(tmp_path / "y.npy")],
                       cwd=tmp_path, env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.split()[:2] == ["ok", "ResNet"]
    np.testing.assert_allclose(np.load(tmp_path / "y.npy"), served["want"],
                               rtol=TOL, atol=TOL)


def test_each_package_refuses_the_others_artifact(served):
    jblob = jserving.export_eval(served["cfg"], (served["enc_vars"],
                                                 served["dec_vars"]), batch=2)
    with pytest.raises(ValueError):
        serving.loads(jblob)
    with pytest.raises(ValueError):
        jserving.loads(served["blob"])
    assert serving.MAGIC != jserving.MAGIC and len(serving.MAGIC) == 8


def test_cpu_artifact_device_checks(served):
    """A CPU artifact loads on the CPU only; a CUDA one (its metadata says
    so) refuses the CPU and is never rerouted there."""
    with pytest.raises(ValueError, match="exported for cpu"):
        serving.loads(served["blob"], device="cuda")
    blob = served["blob"]
    mlen = struct.unpack("<II", blob[8:16])[1]
    meta = json.loads(blob[16:16 + mlen])
    meta["device"] = "cuda"
    raw = json.dumps(meta).encode()
    cuda_blob = (serving.MAGIC + struct.pack("<II", serving.VERSION, len(raw))
                 + raw + blob[16 + mlen:])
    with pytest.raises(ValueError, match="exported for cuda"):
        serving.loads(cuda_blob, device="cpu")


def test_export_needs_a_card_by_default(served):
    if torch.cuda.is_available():
        pytest.skip("the default device is the card here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serving.export_eval(served["tcfg"], served["states"], batch=1)


def test_cli_exports_and_checks(served, tmp_path, capsys):
    """``export_serving.main`` with ``--check`` on the CPU: fresh weights
    (no checkpoint), the artifact written, the served output against the
    eager forward within the bound."""
    out = tmp_path / "m.fairm"
    rc = export_serving.main(
        ["--out", str(out), "--batch", "2", "--check", "--encoder_type",
         "ResNet", "--decoder_type", "ResNet", "--encoder_dim", "16",
         "--dgrn_groups", "1", "--dgrn_blocks", "1", "--patch_size", "32",
         "--crop_test_imgs_size", "32", "--eval_dtype", "float32",
         "--output_path", str(tmp_path) + "/"], device="cpu")
    text = capsys.readouterr().out
    assert rc == 0, text
    assert "no checkpoint found" in text and "serve-check" in text
    assert serving.load(str(out)).input_shape == (2, 32, 32, 3)


def test_graph_launches_counts_fairm_nodes():
    """One count per ``fairm::`` node of a graph, by the kernel's
    ``LAUNCHES`` name (both forms of K9 count as ``window_attn``)."""
    g = torch.fx.Graph()
    x = g.placeholder("x")
    for op in (torch.ops.fairm.lewin_attn.default,
               torch.ops.fairm.lewin_attn.default,
               torch.ops.fairm.window_attn.default,
               torch.ops.fairm.window_attn_mma.default,
               torch.ops.aten.relu.default):
        g.call_function(op, (x,))
    assert custom_ops.graph_launches(g) == {"lewin_attn": 2, "window_attn": 2}


def test_ops_have_no_cpu_implementation():
    """Every forward kernel is a ``fairm::`` op with a CUDA implementation
    only: called on CPU tensors it raises."""
    assert set(custom_ops.OPS) == {
        "lewin_attn", "freq_inter", "lewin_ffn", "lewin_attn_split",
        "lewin_ffn_split", "lewin_merged", "freq_merged", "window_attn",
        "window_attn_mma", "dcn"}
    x = torch.zeros(1, 8, 8, 4)
    with pytest.raises(NotImplementedError):
        torch.ops.fairm.lewin_ffn(x, *([torch.zeros(4)] * 8), None, 1e-6)
