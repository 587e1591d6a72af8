"""The port's configuration and command line: a copy of the JAX package's
``config.py`` (reference ``option.py:1-116``), kept here so that the port
imports nothing of the JAX package.

Same flag surface, same defaults, same post-parse derivations (task
shorthands, ``batch_size``, ``encoder_dim`` / ``lr`` from the encoder type,
``contrast_loss_weight`` from L, ``ckpt_path = output_path + "ckpt/"``), so
a command line written for the JAX package's ``test.py`` parses unchanged.
The ``type=bool`` flags keep argparse's behaviour for them: any non-empty
value, ``False`` included, reads as true.

What differs:

* ``--cuda N`` is the index of the CUDA device the entry points run on (the
  JAX package accepts and ignores it);
* ``--remat`` is accepted and carried, and changes nothing;
  :func:`check_ported` raises ``ValueError`` for a mesh the port cannot
  run (``parallel/distributed.py`` runs the others: one rank a card);
* :func:`from_fields` carries over any configuration object with these
  fields, such as the JAX package's ``Config``.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import List, Optional, Sequence, Tuple

_TASK_SHORTHANDS = {
    "2tasks": (
        ["denoising_0", "deraining"],
        ["denoising_bsd68_15", "denoising_bsd68_25", "denoising_bsd68_50", "deraining"],
    ),
    "3tasks": (
        ["denoising_0", "deraining", "dehazing"],
        ["denoising_bsd68_15", "denoising_bsd68_25", "denoising_bsd68_50", "deraining", "dehazing"],
    ),
    "4tasks": (
        ["denoising_0", "deraining", "dehazing", "deblurring"],
        ["denoising_bsd68_15", "denoising_bsd68_25", "denoising_bsd68_50", "deraining", "dehazing", "deblurring"],
    ),
}

ENCODER_DEFAULTS = {
    # encoder_type -> (encoder_dim, lr); reference option.py:80-101
    "ResNet": (256, 1e-3),
    "ViT": (3, 3e-4),
    "Uformer": (256, 2e-4),
    "Oformer": (256, 2e-4),
}

VALID_INJECTION_METHODS = (
    "residual",
    "modulator",
    "self_modulator",
    "deform_conv",
    "attention_residual",
    "attention_kv",
)  # plus dynamic 'all_<N>_bands' and 'all_DC'; reference option.py:40-41


@dataclasses.dataclass(frozen=True)
class Config:
    """Frozen experiment configuration (reference option.py flag-for-flag)."""

    # Input parameters (reference option.py:6-24)
    cuda: int = 0  # index of the CUDA device the entry points run on
    epochs: int = 1000
    epochs_encoder: int = 100
    lr: Optional[float] = None
    contrast_loss_weight: Optional[float] = None
    frequency_l1_loss_weight: float = 0.1
    de_type: Tuple[str, ...] = ("denoising_0", "deraining", "dehazing", "deblurring")
    test_de_type: Tuple[str, ...] = (
        "denoising_bsd68_15", "denoising_bsd68_25", "denoising_bsd68_50",
        "deraining", "dehazing", "deblurring",
    )
    patch_size: int = 128
    num_workers: int = 16
    save_imgs: bool = False
    crop_test_imgs_size: int = 128

    # Path (reference option.py:27)
    output_path: str = "output/tmp/"

    # Network (reference option.py:30-34)
    encoder_type: str = "Uformer"
    decoder_type: str = "Uformer"
    encoder_dim: Optional[int] = None
    frequency_decompose_type: str = "none"

    # Uformer encoder+decoder (reference option.py:37-50)
    debug_mode: bool = False
    encoder_embed_dim: int = 28
    embed_dim: int = 56
    degradation_embedding_method: Tuple[str, ...] = ("residual",)
    learnable_modulator: bool = False
    num_frequency_bands_encoder: int = -1
    num_frequency_bands: int = -1
    num_frequency_bands_l1: int = -1
    frequency_feature_enhancement_method: Tuple[str, ...] = ()
    L: int = 3
    encoder_msa_type: str = "freq"

    # ViT encoder (reference option.py:53-55)
    out_channels: int = 3
    batch_wise_decompose: bool = False
    frequency_decompose_type_2: bool = False

    # ---- additions of the JAX package (not in the reference) ----
    dtype: str = "bfloat16"          # training compute dtype
    eval_dtype: str = "float32"      # eval forward dtype (PSNR parity wants fp32)
    seed: int = 0
    data_root: str = "data/"
    synthetic_data: bool = False     # use a deterministic synthetic dataset (tests/bench)
    mesh_data: int = 1               # ranks along the batch/data axis
    mesh_task: int = 1               # ranks along the task axis
    # multi-host runs: one process a host, each starting its ranks
    # (parallel/distributed.py::spawn)
    coordinator_address: Optional[str] = None
    num_processes: int = 1
    process_id: int = 0
    steps_per_epoch: Optional[int] = None  # override 400*T/batch (reference dataset_utils.py:144)
    ckpt_every: int = 0              # periodic full-state checkpoints (0 = final epoch only)
    # rematerialise each LeWin block in the backward (JAX package). Accepted
    # and without effect here: the blocks' autograd Functions save a block's
    # input (and u, y1 on the merged routes) only and the backward kernels
    # recompute the rest, which is what remat buys on the TPU
    remat: bool = True
    dgrn_groups: int = 5             # DGRN depth (reference decoder_DGRN.py:117-118)
    dgrn_blocks: int = 5
    # cap on each Uformer stage's block count (None = reference depths);
    # for tests and dry runs only
    uformer_depth_cap: Optional[int] = None
    # stochastic-depth peak rate (reference encoder_Uformer.py:750)
    drop_path: float = 0.1

    # ---- derived (reference option.py:76-103) ----
    batch_size: int = dataclasses.field(default=4)
    ckpt_path: str = dataclasses.field(default="output/tmp/ckpt/")

    # ------------------------------------------------------------------
    def validate(self) -> None:
        if self.encoder_type not in ENCODER_DEFAULTS:
            raise ValueError(f"invalid encoder type: {self.encoder_type!r}")  # option.py:103
        if self.decoder_type not in ("ResNet", "Uformer"):
            raise ValueError(f"invalid decoder type: {self.decoder_type!r}")
        _validate_decompose_type(self.frequency_decompose_type)  # option.py:106-116
        for m in self.degradation_embedding_method:
            if m in VALID_INJECTION_METHODS:
                continue
            if m == "all_DC":
                continue
            parts = m.split("_")
            if len(parts) == 3 and parts[0] == "all" and parts[1].isdigit() and parts[2] == "bands":
                continue
            raise ValueError(f"invalid degradation embedding method: {m!r}")
        if self.encoder_msa_type not in ("origin", "freq"):
            raise ValueError(f"invalid encoder_msa_type: {self.encoder_msa_type!r}")

    @property
    def num_bands_all_methods(self) -> Optional[int]:
        """num_bands for the decoder's 'all_*' attention-band modulation, if any.

        Reference decoder_Uformer.py:166-174.
        """
        for m in self.degradation_embedding_method:
            if m == "all_DC":
                return 2
            parts = m.split("_")
            if len(parts) == 3 and parts[0] == "all" and parts[2] == "bands":
                return int(parts[1])
        return None


def check_uformer_window_compat(cfg: Config) -> None:
    """Reject train/eval size combos whose Uformer window clamps differ.

    Uformer clamps each stage's window to the stage resolution (reference
    encoder_Uformer.py:531-533), so the relative-position bias tables'
    SHAPES depend on the image size. A training run shares parameters
    between training patches (``patch_size``) and in-training eval tiles
    (``crop_test_imgs_size``); if the two clamp differently at any stage,
    the eval apply fails on the tables' shapes (the reference fails the
    same way at state-dict load). Called at start-up — config
    construction alone must not reject this (datasets/analysis tooling
    builds configs with no models involved).
    """
    if "Uformer" not in (cfg.encoder_type, cfg.decoder_type):
        return
    # both Uformer halves have 5 window stages: 4 down stages + a
    # bottleneck at p//16 (encoder_Uformer.py:905-921, decoder mirror)
    for s in range(5):
        pw = min(8, cfg.patch_size >> s)
        cw = min(8, cfg.crop_test_imgs_size >> s)
        if pw != cw:
            raise ValueError(
                "patch_size and crop_test_imgs_size clamp Uformer "
                f"stage-{s} windows differently ({pw} vs {cw}); training "
                "and eval share parameters, so both sizes must be >= "
                "8 * 2**(stages-1) or equal (got patch_size="
                f"{cfg.patch_size}, crop_test_imgs_size="
                f"{cfg.crop_test_imgs_size})")


def _validate_decompose_type(value: str) -> None:
    parts = value.split("_")
    if len(parts) == 2 and parts[0].isdigit() and parts[1] == "bands":
        return
    if value in ("DC", "none"):
        return
    raise ValueError(f"invalid frequency decomposition type: {value!r}")


def build_parser() -> argparse.ArgumentParser:
    """Argparse surface, flag-for-flag with reference option.py:3-55."""
    p = argparse.ArgumentParser()
    p.add_argument("--cuda", type=int, default=0)
    p.add_argument("--epochs", type=int, default=1000)
    p.add_argument("--epochs_encoder", type=int, default=100)
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--contrast_loss_weight", type=float, default=None)
    p.add_argument("--frequency_l1_loss_weight", type=float, default=0.1)
    p.add_argument("--de_type", nargs="+", type=str,
                   default=["denoising_0", "deraining", "dehazing", "deblurring"])
    p.add_argument("--test_de_type", nargs="+", type=str,
                   default=["denoising_bsd68_15", "denoising_bsd68_25", "denoising_bsd68_50",
                            "deraining", "dehazing", "deblurring"])
    p.add_argument("--patch_size", type=int, default=128)
    p.add_argument("--num_workers", type=int, default=16)
    p.add_argument("--save_imgs", type=bool, default=False)
    p.add_argument("--crop_test_imgs_size", type=int, default=128)
    p.add_argument("--output_path", type=str, default="output/tmp/")
    p.add_argument("--encoder_type", type=str, default="Uformer")
    p.add_argument("--decoder_type", type=str, default="Uformer")
    p.add_argument("--encoder_dim", type=int, default=None)
    p.add_argument("--frequency_decompose_type", type=str, default="none")
    p.add_argument("--debug_mode", type=bool, default=False)
    p.add_argument("--encoder_embed_dim", type=int, default=28)
    p.add_argument("--embed_dim", type=int, default=56)
    p.add_argument("--degradation_embedding_method", nargs="+", type=str, default=["residual"])
    p.add_argument("--learnable_modulator", type=bool, default=False)
    p.add_argument("--num_frequency_bands_encoder", type=int, default=-1)
    p.add_argument("--num_frequency_bands", type=int, default=-1)
    p.add_argument("--num_frequency_bands_l1", type=int, default=-1)
    p.add_argument("--frequency_feature_enhancement_method", nargs="+", type=str, default=[])
    p.add_argument("--L", type=int, default=3)
    p.add_argument("--encoder_msa_type", type=str, default="freq")
    p.add_argument("--out_channels", type=int, default=3)
    p.add_argument("--batch_wise_decompose", type=bool, default=False)
    p.add_argument("--frequency_decompose_type_2", type=bool, default=False)
    # additions of the JAX package
    p.add_argument("--dtype", type=str, default="bfloat16")
    p.add_argument("--eval_dtype", type=str, default="float32")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--data_root", type=str, default="data/")
    p.add_argument("--synthetic_data", action="store_true")
    p.add_argument("--mesh_data", type=int, default=1)
    p.add_argument("--mesh_task", type=int, default=1)
    p.add_argument("--coordinator_address", type=str, default=None)
    p.add_argument("--num_processes", type=int, default=1)
    p.add_argument("--process_id", type=int, default=0)
    p.add_argument("--steps_per_epoch", type=int, default=None)
    p.add_argument("--ckpt_every", type=int, default=0)
    p.add_argument("--remat", action="store_true", default=True)
    p.add_argument("--no_remat", dest="remat", action="store_false")
    p.add_argument("--dgrn_groups", type=int, default=5)
    p.add_argument("--dgrn_blocks", type=int, default=5)
    p.add_argument("--uformer_depth_cap", type=int, default=None)
    p.add_argument("--drop_path", type=float, default=0.1)
    return p


def finalize(ns: argparse.Namespace) -> Config:
    """Apply the reference's post-parse derivations (option.py:59-116)."""
    de_type = list(ns.de_type)
    test_de_type = list(ns.test_de_type)
    if de_type and de_type[0] in _TASK_SHORTHANDS:  # option.py:66-74
        de_type, test_de_type = (list(x) for x in _TASK_SHORTHANDS[de_type[0]])

    batch_size = len(de_type)  # option.py:76 — exactly one sample per task per batch

    encoder_dim, lr = ns.encoder_dim, ns.lr
    default_dim, default_lr = ENCODER_DEFAULTS.get(ns.encoder_type, (None, None))
    if encoder_dim is None:
        encoder_dim = default_dim
    if lr is None:
        lr = default_lr

    contrast_loss_weight = ns.contrast_loss_weight
    if contrast_loss_weight is None:
        # Fixes the reference's dead assignment (option.py:59-64): the derived
        # value was never written back, leaving opt.contrast_loss_weight None.
        contrast_loss_weight = {3: 0.6, 2: 0.2}.get(ns.L, 0.2)

    output_path = ns.output_path
    cfg = Config(
        cuda=ns.cuda,
        epochs=ns.epochs,
        epochs_encoder=ns.epochs_encoder,
        lr=lr,
        contrast_loss_weight=contrast_loss_weight,
        frequency_l1_loss_weight=ns.frequency_l1_loss_weight,
        de_type=tuple(de_type),
        test_de_type=tuple(test_de_type),
        patch_size=ns.patch_size,
        num_workers=ns.num_workers,
        save_imgs=ns.save_imgs,
        crop_test_imgs_size=ns.crop_test_imgs_size,
        output_path=output_path,
        encoder_type=ns.encoder_type,
        decoder_type=ns.decoder_type,
        encoder_dim=encoder_dim,
        frequency_decompose_type=ns.frequency_decompose_type,
        debug_mode=ns.debug_mode,
        encoder_embed_dim=ns.encoder_embed_dim,
        embed_dim=ns.embed_dim,
        degradation_embedding_method=tuple(ns.degradation_embedding_method),
        learnable_modulator=ns.learnable_modulator,
        num_frequency_bands_encoder=ns.num_frequency_bands_encoder,
        num_frequency_bands=ns.num_frequency_bands,
        num_frequency_bands_l1=ns.num_frequency_bands_l1,
        frequency_feature_enhancement_method=tuple(ns.frequency_feature_enhancement_method),
        L=ns.L,
        encoder_msa_type=ns.encoder_msa_type,
        out_channels=ns.out_channels,
        batch_wise_decompose=ns.batch_wise_decompose,
        frequency_decompose_type_2=ns.frequency_decompose_type_2,
        dtype=ns.dtype,
        eval_dtype=ns.eval_dtype,
        seed=ns.seed,
        data_root=ns.data_root,
        synthetic_data=ns.synthetic_data,
        mesh_data=ns.mesh_data,
        mesh_task=ns.mesh_task,
        coordinator_address=ns.coordinator_address,
        num_processes=ns.num_processes,
        process_id=ns.process_id,
        steps_per_epoch=ns.steps_per_epoch,
        ckpt_every=ns.ckpt_every,
        remat=ns.remat,
        dgrn_groups=ns.dgrn_groups,
        dgrn_blocks=ns.dgrn_blocks,
        uformer_depth_cap=ns.uformer_depth_cap,
        drop_path=ns.drop_path,
        batch_size=batch_size,
        ckpt_path=output_path + "ckpt/",  # option.py:78
    )
    cfg.validate()
    return cfg


def parse_args(argv: Optional[Sequence[str]] = None) -> Config:
    return finalize(build_parser().parse_args(argv))


def make_config(**overrides) -> Config:
    """Programmatic config with the same derivations as the CLI."""
    ns = build_parser().parse_args([])
    for k, v in overrides.items():
        if not hasattr(ns, k):
            raise AttributeError(f"unknown config field: {k}")
        setattr(ns, k, v)
    return finalize(ns)


def options_log_lines(cfg: Config) -> List[str]:
    """Render options.log in the reference's exact format (train.py:39-45)."""
    lines = [f"|{'=' * 151}|"]
    for key, value in dataclasses.asdict(cfg).items():
        if isinstance(value, tuple):
            value = list(value)
        lines.append(f"|{str(key):>50s}|{str(value):<100s}|")
    lines.append(f"|{'=' * 151}|")
    return lines


FIELDS = tuple(f.name for f in dataclasses.fields(Config))
# encoder_type -> encoder_dim (reference option.py:80-101)
ENCODER_DIMS = {k: v[0] for k, v in ENCODER_DEFAULTS.items()}


def from_fields(cfg) -> Config:
    """This configuration from any object that has its fields, such as the
    JAX package's ``config.Config`` (derived fields are taken as they are)."""
    return Config(**{name: getattr(cfg, name) for name in FIELDS})


def check_ported(cfg: Config) -> None:
    """Raise for a value the port cannot run: a mesh of fewer than one rank
    on an axis, or a global batch (``mesh_data * batch_size``, the
    ``mesh_data`` loader batches the training loop joins) that does not
    divide over the ``mesh_data * mesh_task`` ranks (``ValueError``, as the
    JAX package's ``process_slice``). The entry points that run on one
    device (serving, analysis) build with these flags and ignore them."""
    if cfg.mesh_data < 1 or cfg.mesh_task < 1:
        raise ValueError(f"mesh sizes must be at least 1, got mesh_data "
                         f"{cfg.mesh_data} mesh_task {cfg.mesh_task}")
    world = cfg.mesh_data * cfg.mesh_task
    if (cfg.mesh_data * cfg.batch_size) % world:
        raise ValueError(f"global batch {cfg.mesh_data * cfg.batch_size} not "
                         f"divisible by {world} ranks")
