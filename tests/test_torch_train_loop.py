"""The port's training entry point against the JAX package, on the CPU.

``train.main(cfg, device="cpu")`` runs 2 epochs x 2 steps (one phase-A
epoch, one joint epoch) on synthetic data at a tiny size from a state
carried over from a JAX ``create_train_state``; the JAX steps are driven
over the same batches by hand. Compared: the ``train.log`` values (1e-4),
the formats of ``train.log`` / ``results.log`` / ``options.log``, the final
parameters; a restored checkpoint continues with equal bits; ``main``
raises without a card; the synthetic and file-backed train loaders give the
JAX loaders' batches.
"""

import dataclasses
import os
import re

import jax
import numpy as np
import pytest
import torch

from frequency_wised_all_in_one_image_restoration_model_tpu import config
from frequency_wised_all_in_one_image_restoration_model_tpu.data import (
    datasets as jdatasets, synthetic as jsynthetic)
from frequency_wised_all_in_one_image_restoration_model_tpu.models import (
    airnet as jairnet)
from frequency_wised_all_in_one_image_restoration_model_tpu.training import (
    state as jstate, steps as jsteps)
from frequency_wised_all_in_one_image_restoration_model_tpu_torch import (
    config as tconfig, train as ttrain)
from frequency_wised_all_in_one_image_restoration_model_tpu_torch.data import (
    datasets as tdatasets, prefetch as tprefetch, synthetic as tsynthetic)
from frequency_wised_all_in_one_image_restoration_model_tpu_torch.models import (
    airnet as tairnet)
from frequency_wised_all_in_one_image_restoration_model_tpu_torch.training import (
    checkpoint as tckpt, loop as tloop, state as tstate, steps as tsteps)
from frequency_wised_all_in_one_image_restoration_model_tpu_torch.utils import (
    profiling as tprofiling)
from frequency_wised_all_in_one_image_restoration_model_tpu_torch.utils.weights import (
    from_jax, train_state_from_jax)

P = 32
EPOCHS, STEPS = 2, 2
TASKS = ("denoising_bsd68_25", "deraining")


def tiny_cfg(output_path, **kw):
    base = dict(encoder_type="Uformer", decoder_type="Uformer",
                patch_size=P, crop_test_imgs_size=P, encoder_embed_dim=8,
                embed_dim=8, encoder_dim=8, de_type=["2tasks"], L=3,
                encoder_msa_type="freq",
                degradation_embedding_method=["all_DC"],
                uformer_depth_cap=1, remat=False, dtype="float32",
                eval_dtype="float32", drop_path=0.0, synthetic_data=True,
                seed=5, epochs=EPOCHS, epochs_encoder=1, steps_per_epoch=STEPS,
                ckpt_every=1, output_path=str(output_path) + "/")
    base.update(kw)
    cfg = config.make_config(**base)
    return dataclasses.replace(cfg, test_de_type=TASKS)


def carried_state(cfg, init):
    tcfg = tconfig.from_fields(cfg)
    bundle = tairnet.build_models(tcfg, "cpu", eval_mode=False)
    state = tstate.create_train_state(tcfg, bundle)
    tckpt.load_state_tree(state, train_state_from_jax(init))
    return tcfg, bundle, state


@pytest.fixture(scope="module", autouse=True)
def small_and_single_threaded():
    """The tensors here are tiny: one thread is faster than many, most of
    all beside other test workers. The in-training eval scores one 64x64
    image per task instead of four of 160x160."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    patch = pytest.MonkeyPatch()
    patch.setattr(tloop.eval_runner, "build_test_dataset",
                  lambda cfg, task: tsynthetic.SyntheticTestSet(
                      cfg, task, n_images=1, image_size=64, seed=cfg.seed))
    yield
    patch.undo()
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    out = tmp_path_factory.mktemp("train_loop")
    cfg = tiny_cfg(out)
    # the JAX loop by hand: the first batch initialises, then 2 x 2 steps
    loader = jsynthetic.SyntheticTrainLoader(cfg, seed=cfg.seed)
    first = loader.next_batch()
    batches = [loader.next_batch() for _ in range(EPOCHS * STEPS)]
    jb = jairnet.build_models(cfg)
    jst = jstate.create_train_state(cfg, jb, jax.random.PRNGKey(cfg.seed), first)
    init = jax.tree_util.tree_map(np.array, jst)
    steps = [jax.jit(jsteps.make_train_step(cfg, jb, joint=j)) for j in (0, 1)]
    jlog, it = [], iter(batches)
    for epoch in range(EPOCHS):
        jst = jstate.with_learning_rate(jst, jstate.lr_for_epoch(cfg, epoch))
        for _ in range(STEPS):
            jst, m = steps[epoch >= cfg.epochs_encoder](
                jst, jsteps.array_batch(next(it)))
        jlog.append({k: float(v) for k, v in m.items()})
    jfinal = jax.tree_util.tree_map(np.array, jst)

    tcfg, _, state = carried_state(cfg, init)
    seen = []
    final = ttrain.main(tcfg, device="cpu", state=state,
                        progress=lambda e, m: seen.append((e, dict(m))))
    return dict(cfg=cfg, tcfg=tcfg, out=str(out), init=init, jlog=jlog,
                jfinal=jfinal, final=final, seen=seen, batches=batches)


def test_train_log_matches_the_jax_steps(run):
    with open(os.path.join(run["out"], "train.log")) as f:
        lines = f.read().splitlines()
    assert len(lines) == EPOCHS
    a = re.fullmatch(r"Epoch \(0\)  Loss: contrast_loss:(\d+\.\d{4})", lines[0])
    b = re.fullmatch(r"Epoch \(1\)  Loss: l1_loss:(\d+\.\d{4}) "
                     r"contrast_loss:(\d+\.\d{4})", lines[1])
    assert a and b, lines
    assert float(a.group(1)) == pytest.approx(run["jlog"][0]["contrast_loss"],
                                              abs=1e-4 + 5e-5)
    assert float(b.group(1)) == pytest.approx(run["jlog"][1]["l1_loss"],
                                              abs=1e-4 + 5e-5)
    assert float(b.group(2)) == pytest.approx(run["jlog"][1]["contrast_loss"],
                                              abs=1e-4 + 5e-5)


def test_progress_metrics_match_the_jax_steps(run):
    assert [e for e, _ in run["seen"]] == [0, 1]
    for (_, m), jm in zip(run["seen"], run["jlog"]):
        for k in ("loss", "contrast_loss", "l1_loss"):
            assert m[k] == pytest.approx(jm[k], abs=1e-4), k


def test_final_state_matches_the_jax_steps(run):
    final, jfinal = run["final"], run["jfinal"]
    assert final.step == int(jfinal.step) == EPOCHS * STEPS
    assert int(final.moco.queue_ptr) == int(jfinal.moco.queue_ptr)
    np.testing.assert_allclose(final.moco.queue.numpy(), jfinal.moco.queue,
                               rtol=1e-4, atol=1e-4)
    # after four Adam steps a parameter has moved by at most 4 lr; the two
    # packages stay within a fraction of one step of each other
    lr = run["cfg"].lr
    for net in ("encoder", "decoder"):
        want = from_jax({"params": jfinal.params[net]})
        for name, p in getattr(final, net).named_parameters():
            diff = np.abs(p.detach().numpy() - want[name].numpy())
            assert diff.max() <= 2 * lr + 1e-6, (net, name)
            assert diff.mean() <= 0.05 * lr + 1e-7, (net, name, diff.mean())


def test_results_and_options_logs(run):
    with open(os.path.join(run["out"], "results.log")) as f:
        lines = f.read().splitlines()
    assert lines[0] == "2 Epochs Results:" and len(lines) == 1 + len(TASKS)
    for task, line in zip(TASKS, lines[1:]):
        assert re.fullmatch(re.escape(task + ": " + " " * (25 - len(task)))
                            + r"PSNR/SSIM: \d+\.\d{2}/\d\.\d{4}", line), line
    with open(os.path.join(run["out"], "options.log")) as f:
        opts = f.read().splitlines()
    assert opts == tconfig.options_log_lines(run["tcfg"])
    assert opts == config.options_log_lines(run["cfg"])


def test_models_are_back_in_train_mode_after_the_eval(run):
    assert run["final"].encoder.training and run["final"].decoder.training


def test_checkpoints_of_the_run(run):
    ckpt = os.path.join(run["out"], "ckpt")
    # every epoch (ckpt_every=1, both kept), the final one, and the best
    assert sorted(os.listdir(ckpt)) == ["best.pt", "epoch_1.pt", "epoch_2.pt"]
    assert tckpt.latest_epoch(ckpt) == 2
    assert tckpt.select_eval_epoch(ckpt, 7) == 2
    tree = torch.load(os.path.join(ckpt, "epoch_1.pt"), weights_only=True)
    assert tree["train_state"]["step"] == STEPS
    assert tree["train_state"]["optimizer"]["count"] == STEPS
    # the eval entry point reads the same file
    bundle = tairnet.build_models(run["tcfg"], "cpu")
    tckpt.restore_eval(ckpt, 2, bundle)
    for name, v in bundle.decoder.state_dict().items():
        assert torch.equal(v, run["final"].decoder.state_dict()[name])


def _equal_trees(a, b, path=""):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _equal_trees(a[k], b[k], f"{path}/{k}")
    elif torch.is_tensor(a):
        assert torch.equal(a, b), path
    else:
        assert a == b, path


def test_restored_state_continues_with_equal_bits(run):
    _, bundle, fresh = carried_state(run["cfg"], run["init"])
    tckpt.restore(os.path.join(run["out"], "ckpt"), EPOCHS, fresh)
    live = run["final"]
    _equal_trees(tckpt.state_tree(fresh), tckpt.state_tree(live))
    batch = tsteps.array_batch(run["batches"][0], "cpu")
    outs = []
    for state in (fresh, live):
        b = tairnet.ModelBundle(cfg=run["tcfg"], encoder=state.encoder,
                                decoder=state.decoder)
        state, m = tsteps.make_train_step(run["tcfg"], b, joint=True)(state,
                                                                      batch)
        outs.append((tckpt.state_tree(state), float(m["loss"])))
    assert outs[0][1] == outs[1][1]
    _equal_trees(outs[0][0], outs[1][0])


def test_resume_from_startpoint_runs_the_remaining_epochs(run, tmp_path):
    """``startpoint=1`` loads epoch_1.pt and trains epoch 1 only."""
    cfg = dataclasses.replace(run["tcfg"], ckpt_every=0)
    _, _, fresh = carried_state(run["cfg"], run["init"])
    seen = []
    final = ttrain.main(cfg, device="cpu", state=fresh, startpoint=1,
                        progress=lambda e, m: seen.append(e))
    assert seen == [1] and final.step == EPOCHS * STEPS
    with pytest.raises(ValueError, match="no train state"):
        tckpt.save_eval(str(tmp_path), 3, fresh.encoder.state_dict(),
                        fresh.decoder.state_dict())
        tckpt.restore(str(tmp_path), 3, fresh)


def test_retention_keeps_the_last_two_and_the_best(run, tmp_path):
    _, _, state = carried_state(run["cfg"], run["init"])
    keep = tckpt.RetentionPolicy(str(tmp_path), every=1, keep=2)
    for epoch, psnr in enumerate([20.0, 22.0, 21.0, None]):
        keep.maybe_save(epoch, state, psnr)
    assert sorted(os.listdir(tmp_path)) == ["best.pt", "epoch_3.pt",
                                            "epoch_4.pt"]
    assert keep.best_psnr == 22.0
    none = tckpt.RetentionPolicy(str(tmp_path / "none"), every=0)
    assert none.maybe_save(0, state, None) is None
    assert not os.path.exists(tmp_path / "none")


def test_main_raises_without_a_card(run, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.main(run["tcfg"])
    with pytest.raises(ValueError, match="needs a device"):
        tloop.run_training(run["tcfg"])


def test_cli_runs_as_a_module_and_needs_a_card(tmp_path):
    """``python -m <port>.train`` parses the flags and, on a host without a
    card, fails with the device error instead of training on the CPU."""
    import subprocess
    import sys
    from pathlib import Path

    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    repo = Path(__file__).resolve().parents[1]
    r = subprocess.run(
        [sys.executable, "-m",
         "frequency_wised_all_in_one_image_restoration_model_tpu_torch.train",
         "--synthetic_data", "--degradation_embedding_method", "all_DC",
         "--patch_size", "32", "--crop_test_imgs_size", "32", "--epochs", "1",
         "--output_path", str(tmp_path) + "/"],
        cwd=repo, env=dict(os.environ, PYTHONPATH=str(repo)),
        capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and "no CUDA device" in r.stderr
    assert not os.path.exists(tmp_path / "train.log")


def test_not_ported_values_are_refused(run):
    cfg = dataclasses.replace(run["tcfg"], mesh_data=2)
    with pytest.raises(NotImplementedError, match="one card"):
        ttrain.main(cfg, device="cpu")
    # --remat is accepted and changes nothing
    tconfig.check_ported(dataclasses.replace(run["tcfg"], remat=True))


def test_synthetic_train_loader_matches():
    cfg = tiny_cfg("unused", de_type=["3tasks"])
    a = jsynthetic.SyntheticTrainLoader(cfg, seed=4)
    b = tsynthetic.SyntheticTrainLoader(tconfig.from_fields(cfg), seed=4)
    for _ in range(2):
        ja, tb = a.next_batch(), b.next_batch()
        assert ja.keys() == tb.keys()
        for k in ("d1", "d2", "c1", "c2", "de_id"):
            np.testing.assert_array_equal(ja[k], tb[k])
        assert ja["names"] == tb["names"]
        assert tb["d1"].shape == (3, P, P, 3) and tb["d1"].dtype == np.float32
    t = tsteps.array_batch(tb, "cpu")
    assert set(t) == set(tsteps.ARRAY_BATCH_KEYS) and "names" not in t


def _write_tree(root, rng):
    from PIL import Image

    for task, pairs in (("denoising", False), ("deraining", True)):
        for sub in ("GT",) + (("Input",) if pairs else ()):
            os.makedirs(os.path.join(root, f"{task}_train", sub))
        for i in range(3):
            img = rng.integers(0, 255, (48, 64, 3), dtype=np.uint8)
            Image.fromarray(img).save(
                os.path.join(root, f"{task}_train", "GT", f"im{i}.png"))
            if pairs:
                Image.fromarray(255 - img).save(os.path.join(
                    root, f"{task}_train", "Input", f"im{i}_rain.png"))


def test_file_train_loader_matches(tmp_path):
    _write_tree(str(tmp_path), np.random.default_rng(0))
    cfg = tiny_cfg("unused", synthetic_data=False,
                   data_root=str(tmp_path) + "/", de_type=["denoising_15",
                                                          "deraining"])
    a = jdatasets.FileTrainLoader(cfg, seed=2)
    b = tdatasets.FileTrainLoader(tconfig.from_fields(cfg), seed=2)
    assert a.total_pairs() == b.total_pairs() == 6
    assert b.steps_per_epoch() == STEPS
    for _ in range(4):  # past one reshuffle of the three images per task
        ja, tb = a.next_batch(), b.next_batch()
        for k in ("d1", "d2", "c1", "c2", "de_id"):
            np.testing.assert_array_equal(ja[k], tb[k])
        assert ja["names"] == tb["names"]


def test_file_train_loader_needs_its_tree(tmp_path):
    cfg = tconfig.from_fields(tiny_cfg("unused", synthetic_data=False,
                                       data_root=str(tmp_path) + "/"))
    with pytest.raises(FileNotFoundError):
        tdatasets.FileTrainLoader(cfg, seed=0)
    with pytest.raises(FileNotFoundError):
        tloop.build_train_loader(cfg)


def test_prefetcher_keeps_the_order_and_surfaces_errors():
    class Counter:
        def __init__(self):
            self.n = 0

        def next_batch(self):
            self.n += 1
            if self.n > 3:
                raise RuntimeError("out of data")
            return {"i": self.n}

        def total_pairs(self):
            return 7

    pre = tprefetch.Prefetcher(Counter())
    assert [pre.next_batch()["i"] for _ in range(3)] == [1, 2, 3]
    assert pre.total_pairs() == 7
    with pytest.raises(RuntimeError, match="out of data"):
        pre.next_batch()
    pre.close()


def test_step_meter_reports_every_n_steps():
    meter = tprofiling.StepMeter(batch=4, patch=128, every=2)
    assert meter.step() is None
    stats = meter.step()
    assert set(stats) == {"steps_per_sec", "samples_per_sec", "train_mps"}
    assert stats["samples_per_sec"] == pytest.approx(4 * stats["steps_per_sec"])
    assert stats["train_mps"] == pytest.approx(
        stats["samples_per_sec"] * 128 * 128 / 1e6)
    assert meter.step() is None
