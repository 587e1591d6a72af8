"""The port's decoder conditioning against the JAX package, part 3: the
combined configurations (``residual self_modulator all_DC``; ``residual``
with ``--learnable_modulator`` and ``--frequency_decompose_type DC``, the
learnable ``lamb``; the per-scale set ``residual modulator self_modulator
deform_conv attention_kv`` with the learnable modulator, at
``uformer_depth_cap=2`` so that the shifted blocks run), the eval forward
within 1e-4; and ``tools/jax_ckpt_to_torch.py`` converting an Orbax
checkpoint of them into ``.pt`` files the port loads with ``strict=True``.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_injection_setup import check_config, run_config
from frequency_wised_all_in_one_image_restoration_model_tpu_torch.models import (
    airnet as tairnet)
from frequency_wised_all_in_one_image_restoration_model_tpu_torch.training import (
    checkpoint as tckpt)

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def single_threaded():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", params=["residual_self_modulator_all_DC",
                                        "residual_modulator_lamb_DC",
                                        "per_scale_set"])
def run(request):
    return run_config(request.param)


def test_eval_forward_matches_jax(run):
    check_config(run)


def test_orbax_checkpoint_converts_every_new_parameter(run, tmp_path):
    """An Orbax ``epoch_2`` of the JAX package -> ``epoch_2.pt``: the DCN
    ``weight`` (HWIO, raw), ``modulator``, ``lamb`` and the
    ``degradation_embed_*`` Linears load with ``strict=True`` and equal the
    JAX values."""
    from frequency_wised_all_in_one_image_restoration_model_tpu.training import (
        checkpoint as jckpt)
    from frequency_wised_all_in_one_image_restoration_model_tpu.training.state import (
        TrainState)

    spec = importlib.util.spec_from_file_location(
        "jax_ckpt_to_torch", REPO / "tools" / "jax_ckpt_to_torch.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    split = lambda v: (v["params"], {k: x for k, x in v.items() if k != "params"})
    (ep, ee), (dp, de) = split(run["enc_vars"]), split(run["dec_vars"])
    state = TrainState(step=np.zeros((), np.int32),
                       params={"encoder": ep, "decoder": dp},
                       extra={"encoder": ee, "decoder": de},
                       moco={"queue": np.zeros((2, 3), np.float32)},
                       opt_state={"count": np.zeros((), np.int32)},
                       rng=np.zeros((2,), np.uint32))
    ckpt_path = str(tmp_path / "ckpt")
    jckpt.save(ckpt_path, 2, state)
    assert tool.main(["--ckpt_path", ckpt_path, "--epoch", "2"]) == 0

    bundle = tairnet.build_models(run["bundle"].cfg, "cpu")
    tckpt.restore_eval(ckpt_path, 2, bundle)
    sd = bundle.decoder.state_dict()
    want = run["bundle"].decoder.state_dict()
    for k, v in sd.items():
        torch.testing.assert_close(v, want[k], rtol=0, atol=0)
    names = set(sd)
    methods = run["cfg"].degradation_embedding_method
    expect = ["degradation_embed_4.weight", "degradation_embed_0.weight"]
    if run["cfg"].learnable_modulator:
        expect.append("decoderlayer_0.block0.modulator")
    if run["cfg"].frequency_decompose_type == "DC":
        expect.append("decoderlayer_0.block0.attn.lamb")
    if "deform_conv" in methods:
        expect.append("bottleneck_1.block0.mlp.dcn.weight")
        dcn = sd["decoderlayer_3.block0.mlp.dcn.weight"]
        assert tuple(dcn.shape) == (3, 3, 64, 64)   # HWIO at C = 4 * 2^4
    if "attention_kv" in methods:
        expect += ["bottleneck_1.block0.attn.qkv.to_k.weight",
                   "decoderlayer_2.block1.attn.qkv.to_v.weight"]
    missing = [k for k in expect if k not in names]
    assert not missing


def test_per_scale_set_routes_and_launch_points():
    """Which blocks leave the fused path: the encoder's last block of each
    stage (need_kv, shifted where res > 8) and every block of bottleneck_1
    and the up stages; the rest stay fused."""
    bundle = run_config("per_scale_set")["bundle"]
    enc, dec = bundle.encoder, bundle.decoder
    unfused = lambda m: sorted(n for n, b in m.named_modules()
                               if getattr(b, "unfused", False))
    assert unfused(enc) == [f"{s}.block1" for s in (
        "bottleneck", "encoderlayer_0", "encoderlayer_1", "encoderlayer_2",
        "encoderlayer_3")]
    assert enc.encoderlayer_0.block1.shift == 4
    want = ["bottleneck_1.block0", "bottleneck_1.block1"] + [
        f"decoderlayer_{s}.block{i}" for s in range(4) for i in range(2)]
    assert unfused(dec) == sorted(want)
