"""Train state: everything a step changes, held in one object (the port of
the JAX ``training/state.py``).

The query encoder and the decoder are modules in train mode; the MoCo key
encoder, queue and pointer are a :class:`MoCoState`; Adam runs over both
models' parameters; one ``torch.Generator`` on the models' device feeds
DropPath. A step updates all of it in place.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import List

import torch
from torch import nn

from ..models import moco
from ..models.airnet import ModelBundle


@dataclasses.dataclass
class TrainState:
    step: int                       # global step
    encoder: nn.Module              # query encoder
    decoder: nn.Module
    moco: moco.MoCoState
    optimizer: torch.optim.Adam
    generator: torch.Generator      # DropPath draws, on the models' device

    def parameters(self) -> List[nn.Parameter]:
        """Encoder then decoder parameters, the optimizer's order."""
        return list(self.encoder.parameters()) + list(self.decoder.parameters())


def reproducible_backends() -> None:
    """Make a training step give equal bits when run twice from one state,
    as the JAX package's steps do. cuDNN picks its convolution algorithms
    by timing them (``benchmark``) and may pick weight-gradient algorithms
    that add with float atomics, so the ResNet encoder's and the decoders'
    convolutions (InputProj, Downsample, Upsample, OutputProj, DGRN, the
    offset heads) would change their gradients from run to run in the last
    bits; ``deterministic`` restricts it to reproducible ones. The port's
    own kernels need nothing: none adds with float atomics."""
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False


def make_optimizer(cfg, params) -> torch.optim.Adam:
    """Adam over the full parameter list (reference train.py:63), PyTorch's
    defaults (betas 0.9 / 0.999, eps 1e-8), which are also optax's."""
    return torch.optim.Adam(params, lr=cfg.lr)


def lr_for_epoch(cfg, epoch: int) -> float:
    """Staircase LR as a function of the epoch being *trained*.

    The reference constructs Adam with ``opt.lr`` and re-assigns the LR at
    the END of each epoch from the just-finished epoch index
    (train.py:142-149), so epoch ``e`` trains with the value derived from
    ``e - 1``:
      phase A (e-1 <= epochs_encoder): lr * 0.1^((e-1)//60)
      phase B: 1e-4 * 0.5^((e-1-epochs_encoder)//125)
    """
    if epoch == 0:
        return cfg.lr
    prev = epoch - 1
    if prev <= cfg.epochs_encoder:
        return cfg.lr * (0.1 ** (prev // 60))
    return 1e-4 * (0.5 ** ((prev - cfg.epochs_encoder) // 125))


def with_learning_rate(state: TrainState, lr: float) -> TrainState:
    """Assign the LR, as the reference pokes ``param_group['lr']``."""
    for group in state.optimizer.param_groups:
        group["lr"] = lr
    return state


def create_train_state(cfg, bundle: ModelBundle) -> TrainState:
    """The state of a fresh run around a train-mode bundle: key encoder = a
    copy of the query encoder, queue = normalised randn of K = 3 * batch
    columns (moco.py:33-40, model.py:35), Adam with no history, all drawn
    from one generator seeded with ``cfg.seed``."""
    device = bundle.device
    generator = torch.Generator(device=device).manual_seed(cfg.seed)
    encoder_k = copy.deepcopy(bundle.encoder)
    for p in encoder_k.parameters():
        p.requires_grad_(False)
    queue = moco.init_queue(generator, bundle.num_losses, cfg.encoder_dim,
                            3 * cfg.batch_size)
    params = list(bundle.encoder.parameters()) + list(bundle.decoder.parameters())
    return TrainState(
        step=0, encoder=bundle.encoder, decoder=bundle.decoder,
        moco=moco.MoCoState(encoder_k=encoder_k, queue=queue,
                            queue_ptr=torch.zeros((), dtype=torch.int64,
                                                  device=device)),
        optimizer=make_optimizer(cfg, params), generator=generator)
