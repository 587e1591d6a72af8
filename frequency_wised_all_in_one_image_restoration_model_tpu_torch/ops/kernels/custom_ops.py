"""The forward kernels as ``torch.library`` custom ops, so that
``torch.export`` can trace the eval forward into one program
(``serving.py``).

Each op ``fairm::<name>`` is one forward launch of the kernel wrappers
(``lewin_block.launch_*``, ``window_attention.launch_window_attn*``,
``deform_conv.launch_dcn``): its operands checked and in the kernel's
formats, its shapes and its form (fused or passes, the parts of a split
reduction) as plain arguments, which the wrapper chose from shapes alone.
The op allocates its scratch and its output, launches, and adds one to its
kernel's ``LAUNCHES`` count, so that a served forward counts its launches
as an eager one does. Each has a fake function that gives the output's
shape, dtype and strides from the inputs' shapes.

Only a CUDA implementation is registered: called with CPU tensors an op
raises. The CPU path is the wrappers' plain twins, taken before any op.
While ``torch.export`` traces, the wrappers call the ops
(``lewin_block._launch``); otherwise they call the launches directly.

Importing this module registers the ops; it builds no kernel. A program
that holds the ops needs this module imported before it is loaded.
"""

import torch

from .. import deform_conv
from . import lewin_block as lb
from . import window_attention as wa


def _like_x(x, *_):
    return torch.empty_like(x)


def _window_attn_mma(q, k, v, bias, mask, scale, nW):
    q5 = q if q.dim() == 5 else q.unsqueeze(2)
    W, h, L, nb, d = q5.shape
    return q.new_empty((L, W, nb, h, d))


def _dcn(x, offset, mask, wt, bias, kh, kw, padding, dilation, clamp,
         implicit):
    b, ho, wo = offset.shape[:3]
    return x.new_empty((b, ho, wo, wt.shape[0]))


# op name -> (its launch, its fake, the LAUNCHES count it adds to)
OPS = {
    "lewin_attn": (lb.launch_attn, _like_x, "lewin_attn"),
    "freq_inter": (lb.launch_freq_inter, _like_x, "freq_inter"),
    "lewin_ffn": (lb.launch_ffn, _like_x, "lewin_ffn"),
    "lewin_attn_split": (lb.launch_attn_split, _like_x, "lewin_attn_split"),
    "lewin_ffn_split": (lb.launch_ffn_split, _like_x, "lewin_ffn_split"),
    "lewin_merged": (lb.launch_merged, _like_x, "lewin_merged"),
    "freq_merged": (lb.launch_freq_merged, _like_x, "freq_merged"),
    "window_attn": (wa.launch_window_attn, _like_x, "window_attn"),
    "window_attn_mma": (wa.launch_window_attn_mma, _window_attn_mma,
                        "window_attn"),
    "dcn": (deform_conv.launch_dcn, _dcn, "dcn"),
}

for _name, (_launch, _fake, _) in OPS.items():
    torch.library.custom_op(f"fairm::{_name}", _launch, mutates_args=(),
                            device_types="cuda").register_fake(_fake)


_COUNTED = (lb, wa, deform_conv)


def reset_launches() -> None:
    """Set every kernel's ``LAUNCHES`` count to 0."""
    for m in _COUNTED:
        m.reset_launches()


def read_launches() -> dict:
    """Every kernel's ``LAUNCHES`` count, forward and backward."""
    return {k: v for m in _COUNTED for k, v in m.LAUNCHES.items()}


def graph_launches(graph) -> dict:
    """The launches a program's graph (``torch.fx.Graph``) holds, by
    ``LAUNCHES`` count: one per ``fairm::`` node."""
    counts = {}
    for node in graph.nodes:
        ns = getattr(node.target, "namespace", None)
        if node.op == "call_function" and ns == "fairm":
            key = OPS[node.target._opname][2]
            counts[key] = counts.get(key, 0) + 1
    return counts
