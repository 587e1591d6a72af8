"""The port's decoder conditioning against the JAX package, part 1: the
whole tiny encoder + decoder eval forward (P=32, widths 4,
``uformer_depth_cap=1``) for ``all_DC``, ``all_3_bands``, ``residual`` and
``self_modulator``, within 1e-4 (setup in
``tests/test_torch_injection_setup.py``); and the eval entry point
``test.main`` with the CLI's default method, ``residual``, against the JAX
runner: equal result strings."""

import zlib

import pytest
import torch

from test_torch_injection_setup import check_config, run_config, tiny_cfg
from frequency_wised_all_in_one_image_restoration_model_tpu.data import (
    synthetic as jsynthetic)
from frequency_wised_all_in_one_image_restoration_model_tpu.evaluation import (
    runner as jrunner)
from frequency_wised_all_in_one_image_restoration_model_tpu_torch import (
    config as tconfig, test as ttest)
from frequency_wised_all_in_one_image_restoration_model_tpu_torch.data import (
    synthetic as tsynthetic)
from frequency_wised_all_in_one_image_restoration_model_tpu_torch.training import (
    checkpoint as tckpt)
from frequency_wised_all_in_one_image_restoration_model_tpu_torch.utils.weights import (
    from_jax)

TASK = "denoising_bsd68_25"


@pytest.fixture(scope="module", autouse=True)
def single_threaded():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module",
                params=["all_DC", "all_3_bands", "residual", "self_modulator"])
def run(request):
    return run_config(request.param)


def test_eval_forward_matches_jax(run):
    check_config(run)


def test_all_bands_need_enough_encoder_bands():
    """The JAX ValueError: all_3_bands on an encoder of 2 bands."""
    from frequency_wised_all_in_one_image_restoration_model_tpu_torch.models import (
        airnet as tairnet)
    cfg = tconfig.from_fields(tiny_cfg(L=2,
                                       degradation_embedding_method=["all_3_bands"]))
    bundle = tairnet.build_models(cfg, "cpu")
    x = torch.rand(1, 32, 32, 3)
    with pytest.raises(ValueError, match="bands"):
        tairnet.eval_forward(bundle, x)


def test_default_method_is_residual():
    assert tconfig.parse_args([]).degradation_embedding_method == ("residual",)


def test_eval_entry_point_with_default_flags_matches_jax(tmp_path, monkeypatch,
                                                         capsys):
    """``test.main(cfg, device="cpu")`` with the CLI's default method on
    weights from a JAX init: the result strings equal the JAX runner's."""
    for mod in (jsynthetic, tsynthetic):
        monkeypatch.setattr(mod, "hash", lambda s: zlib.crc32(s.encode()),
                            raising=False)
    out = str(tmp_path) + "/"
    cfg = tiny_cfg(output_path=out, epochs=1, test_de_type=[TASK],
                   de_type=["denoising_0", "deraining"], synthetic_data=True)
    assert cfg.degradation_embedding_method == ("residual",)
    r = run_config("residual")
    tcfg = tconfig.from_fields(cfg)
    tckpt.save_eval(tcfg.ckpt_path, 1, from_jax(r["enc_vars"]),
                    from_jax(r["dec_vars"]))
    rows = ttest.main(tcfg, device="cpu")
    assert "loaded checkpoint epoch_1" in capsys.readouterr().out
    want = jrunner.test_by_task(cfg, r["jb"], r["enc_vars"], r["dec_vars"],
                                TASK, epochs=1,
                                eval_fn=jrunner.make_eval_fn(r["jb"]))
    assert rows == [(TASK, want)]
