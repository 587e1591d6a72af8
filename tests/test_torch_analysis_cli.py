"""The port's analysis CLIs (``<port>/scripts/``, one per root ``plot_*.py``
and the sweep runner): each ``main(cfg, device="cpu")`` at tiny flags
(``--uformer_depth_cap 1``, width 4, ``--patch_size 32``, synthetic data)
writes its file or prints its lines in the root script's format. Where the
root script needs no model (the log parsers, the histograms of the loaders
and test sets), it runs in this process on the same flags and its output
must equal the port's line for line. ``multi_experiments`` runs against a
stub interpreter that records its argv, beside the root script. Every
``main`` raises without a card when ``device`` is None, and importing every
``scripts`` module loads nothing of JAX or of the JAX package."""

import importlib
import os
import re
import runpy
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from frequency_wised_all_in_one_image_restoration_model_tpu_torch import (
    config as tconfig)
from frequency_wised_all_in_one_image_restoration_model_tpu_torch.models import (
    uformer_lewin as tlewin)
from frequency_wised_all_in_one_image_restoration_model_tpu_torch.utils.logging import (
    RunLogs)

REPO = Path(__file__).resolve().parents[1]
PKG = "frequency_wised_all_in_one_image_restoration_model_tpu_torch"
PLOTS = sorted(p.stem for p in REPO.glob("plot_*.py"))
CLIS = PLOTS + ["multi_experiments"]
TINY = ["--synthetic_data", "--uformer_depth_cap", "1",
        "--encoder_embed_dim", "4", "--embed_dim", "4", "--patch_size", "32",
        "--crop_test_imgs_size", "32", "--degradation_embedding_method",
        "all_DC", "--de_type", "denoising_0", "deraining"]
FLOAT = r"-?\d+\.\d+(e[-+]\d+)?"


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _script(name):
    return importlib.import_module(f"{PKG}.scripts.{name}")


def _flags(tmp_path, *extra):
    return TINY + ["--output_path", f"{tmp_path}/"] + list(extra)


def _port(name, flags, capsys):
    """The port's ``main`` on the CPU; its stdout lines."""
    capsys.readouterr()
    _script(name).main(tconfig.parse_args(flags), device="cpu")
    return capsys.readouterr().out.splitlines()


def _root(name, flags, capsys, monkeypatch):
    """The root script run as ``__main__`` on ``flags``; its stdout lines."""
    capsys.readouterr()
    monkeypatch.setattr(sys, "argv", [f"{name}.py"] + list(flags))
    runpy.run_path(str(REPO / f"{name}.py"), run_name="__main__")
    return capsys.readouterr().out.splitlines()


def test_every_root_script_has_a_cli():
    assert len(PLOTS) == 14
    for name in CLIS:
        assert callable(_script(name).main)


@pytest.mark.parametrize("name", CLIS)
def test_main_raises_without_a_card(name, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    mod = _script(name)
    cfg = (mod.parse_args([]) if name == "multi_experiments"
           else tconfig.parse_args(_flags(tmp_path)))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(cfg)


def test_scripts_import_no_jax():
    code = ("import sys\n"
            + "".join(f"import {PKG}.scripts.{n}\n" for n in CLIS)
            + "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', "
            "'frequency_wised_all_in_one_image_restoration_model_tpu'))\n"
            "assert not bad, bad\n"
            "assert 'matplotlib' not in sys.modules\n"
            "assert 'sklearn' not in sys.modules\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]


# ---------------------------------------------------------------------------
# the scripts with no model: the root script's lines, equal
# ---------------------------------------------------------------------------

RESULTS = ("101 Epochs Results:\n"
           "denoising_bsd68_25:        PSNR/SSIM: 30.12/0.8712\n"
           "deraining:                 PSNR/SSIM: 28.50/0.8301\n"
           "102 Epochs Results:\n"
           "denoising_bsd68_25:        PSNR/SSIM: 31.00/0.8800\n"
           "deraining:                 PSNR/SSIM: 29.00/0.8400\n")


def _logs(tmp_path):
    """results.log, epoch_<N>_results.log and train.log in the reference's
    formats under ``tmp_path``."""
    logs = RunLogs(tconfig.parse_args(_flags(tmp_path)))
    logs.log_epoch_encoder(0, 1.2345)
    logs.log_epoch_joint(1, 0.0321, 0.9876)
    logs.close()
    (tmp_path / "results.log").write_text(RESULTS)
    for i, psnr in ((100, 30.5), (200, 31.25)):
        (tmp_path / f"epoch_{i}_results.log").write_text(
            f"denoising_bsd68_25:   PSNR/SSIM: {psnr}/0.88\n"
            f"deraining:            PSNR/SSIM: {psnr - 2}/0.83\n")


@pytest.mark.parametrize("name,extra", [
    ("plot_performance", ["--test_de_type", "denoising_bsd68_25", "deraining"]),
    ("plot_performance_curve", ["--test_de_type", "denoising_bsd68_25",
                                "deraining", "--epochs", "200"]),
    ("plot_loss_curve", []),
    ("plot_frequency_distribution", ["--test_de_type", "denoising_bsd68_25",
                                     "deraining"]),
    ("plot_frequency_distribution_1", []),
    ("plot_frequency_distribution_2", []),
    ("plot_frequency_distribution_4", []),
])
def test_lines_equal_the_root_script(name, extra, tmp_path, capsys,
                                     monkeypatch):
    _logs(tmp_path)
    flags = _flags(tmp_path, *extra)
    got = _port(name, flags, capsys)
    assert got
    for line in got:
        if line.startswith("wrote "):
            assert os.path.isfile(line.split(" ", 1)[1]), line
    assert got == _root(name, flags, capsys, monkeypatch)


# ---------------------------------------------------------------------------
# the scripts that run the model: their files and line formats
# ---------------------------------------------------------------------------


def _decoder_blocks(flags):
    from frequency_wised_all_in_one_image_restoration_model_tpu_torch.models import (
        airnet)
    b = airnet.build_models(tconfig.parse_args(flags), "cpu")
    return sum(isinstance(m, tlewin.LeWinBlock) for m in b.decoder.modules())


@pytest.mark.parametrize("name", ["plot_MSA_frequency_curve",
                                  "plot_TSNE_distribution",
                                  "plot_frequency_distribution_3"])
def test_plot_is_written(name, tmp_path, capsys):
    got = _port(name, _flags(tmp_path, "--test_de_type", "deraining"), capsys)
    assert len(got) == 1 and got[0].startswith("wrote ")
    assert os.path.getsize(got[0].split(" ", 1)[1]) > 0


def test_msa_frequency_lines(tmp_path, capsys):
    flags = _flags(tmp_path)
    got = _port("plot_MSA_frequency", flags, capsys)
    assert len(got) == _decoder_blocks(flags)
    pat = rf"^[\w/]+/attn/attn_map/0 \[{FLOAT}(, {FLOAT}){{4}}\]$"
    assert all(re.match(pat, line) for line in got), got[:2]
    assert got == sorted(got)


def test_embed_lamb_lines(tmp_path, capsys):
    flags = _flags(tmp_path)
    got = _port("plot_embed_lamb_curve", flags, capsys)
    n = _decoder_blocks(flags)
    cfg = tconfig.parse_args(flags)
    assert len(got) == len(cfg.de_type) * (n + 1)
    for i, task in enumerate(cfg.de_type):
        assert got[i * (n + 1)] == task
        for line in got[i * (n + 1) + 1:(i + 1) * (n + 1)]:
            assert re.match(rf"^  [\w/]+/attn/embed_lamb_1/0 \[{FLOAT}"
                            rf"(, {FLOAT})*\]$", line), line


def test_lamb_lines(tmp_path, capsys):
    """With the learnable DC ``lamb`` of ``--frequency_decompose_type DC``:
    one line a decoder attention, its ``[1, 1, h]`` gains as a nested
    list."""
    flags = _flags(tmp_path, "--frequency_decompose_type", "DC")
    got = _port("plot_lamb_curve", flags, capsys)
    assert len(got) == _decoder_blocks(flags)
    assert all(re.match(rf"^decoder/[\w/]+/attn/lamb \[\[\[{FLOAT}"
                        rf"(, {FLOAT})*\]\]\]$", line) for line in got), got[:2]


def test_lfs_lines(tmp_path, capsys):
    got = _port("plot_LFS_distribution", _flags(tmp_path), capsys)
    assert re.match(rf"^threshold={FLOAT} kept \d+/\d+ channels$", got[0])
    kept, total = map(int, re.search(r"kept (\d+)/(\d+)", got[0]).groups())
    assert 0 < kept <= total
    assert len(got) == 11
    assert all(re.match(rf"^encoder/[\w/]+ {FLOAT}$", line)
               for line in got[1:]), got[1:3]


# ---------------------------------------------------------------------------
# the sweep runner
# ---------------------------------------------------------------------------


STUB = """#!/bin/sh
printf '%s\\n' "$*" >> "{log}"
"""


def test_multi_experiments_against_a_stub(tmp_path, monkeypatch):
    """Host 1 of 2 runs experiments 1 and 3 of four, each ``.train`` then
    ``.test`` of the port with the slug's output path; the log and the
    slugs are the root script's."""
    import multi_experiments as root_me

    stub = tmp_path / "python"
    calls = tmp_path / "calls.txt"
    stub.write_text(STUB.format(log=calls))
    stub.chmod(0o755)
    sweep = ["--L 3 --epochs 2", "--L 2", "--encoder_type ViT", "--L 1"]
    (tmp_path / "sweep.txt").write_text("# a comment\n" + "\n".join(sweep))
    monkeypatch.chdir(tmp_path)
    me = _script("multi_experiments")
    cfg = me.parse_args(["--sweep_file", "sweep.txt", "--train", "--test",
                         "--num_hosts", "2", "--host_index", "1"])
    done = me.main(cfg, device="cpu", python=str(stub))
    assert done == [(sweep[1], True), (sweep[3], True)]
    lines = calls.read_text().splitlines()
    assert lines == [
        f"-m {PKG}.{entry} {hp} --output_path output/h{root_me.tostr(hp)}/"
        for hp in (sweep[1], sweep[3]) for entry in ("train", "test")]
    ours = (tmp_path / "multi_experiments.log").read_text()
    with open(tmp_path / "root.log", "w") as log:
        for hp in (sweep[1], sweep[3]):
            root_me.experiment(hp, train=True, test=True, log_file=log,
                               python=str(stub))
    assert ours == (tmp_path / "root.log").read_text()
    assert all(me.tostr(hp) == root_me.tostr(hp) for hp in sweep)
    failing = tmp_path / "fail"
    failing.write_text("#!/bin/sh\nexit 3\n")
    failing.chmod(0o755)
    assert me.main(cfg, device="cpu", python=str(failing)) == [
        (sweep[1], False), (sweep[3], False)]
    assert "[Error]" in (tmp_path / "multi_experiments.log").read_text()
