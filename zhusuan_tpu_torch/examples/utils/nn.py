"""Minimal explicit-parameter neural-net helpers for the port's examples.

Port of ``examples/utils/nn.py`` (``init_linear``, ``linear_apply``,
``init_mlp``, ``mlp_apply``, and the conv helpers ``init_conv``,
``conv_apply``, ``deconv_apply`` of ``nn.py:80-110``): parameters are
nested dicts and lists of leaf tensors, a dense layer ``{"w": [in, out],
"b": [out]}``, a conv layer ``{"w": [out, in, kh, kw], "b": [out]}``
(torch's OIHW where the JAX package keeps HWIO). Activations keep the JAX
package's channels-last layout, ``[..., H, W, C]``, so a flattened
feature map has its order and a dense layer after it its weights; each
conv runs on an NCHW view of it (channels-last in memory).
:func:`params_from_numpy` and :func:`params_to_numpy` carry such trees to
and from numpy (the JAX package's weights cross over that way; a 4-D
``"w"`` is a conv kernel and is transposed between HWIO and OIHW).
Nothing here sets torch's global matmul or convolution flags (TF32 and
the like): a float32 product is what the caller's settings make it.
"""

from __future__ import annotations

import math
from typing import Callable, List, Sequence, Tuple

import numpy as np
import torch

__all__ = [
    "init_linear",
    "linear_apply",
    "init_mlp",
    "mlp_apply",
    "init_conv",
    "conv_apply",
    "deconv_apply",
    "params_from_numpy",
    "params_to_numpy",
]


def init_linear(generator, n_in: int, n_out: int, dtype=torch.float32,
                device=None):
    """He-initialized dense layer ``{"w": [in, out], "b": [out]}``: ``w``
    normal with std ``sqrt(2 / n_in)`` drawn from ``generator`` (a
    ``torch.Generator`` on ``device``; None takes the generator's device),
    ``b`` zero; leaf tensors that require grad."""
    device = _device(device, generator)
    w = torch.randn((n_in, n_out), generator=generator, dtype=dtype,
                    device=device) * math.sqrt(2.0 / n_in)
    return {"w": w.requires_grad_(True),
            "b": torch.zeros(n_out, dtype=dtype,
                             device=device).requires_grad_(True)}


def linear_apply(params, x, compute_dtype=None):
    """Dense layer ``x @ w + b``. ``compute_dtype`` (e.g.
    ``torch.bfloat16``) casts the input and the weights for the product
    (mixed precision: parameters and optimizer state keep their dtype, and
    the cast's backward brings the gradients back to it)."""
    if compute_dtype is not None:
        x = x.to(compute_dtype)
        return x @ params["w"].to(compute_dtype) \
            + params["b"].to(compute_dtype)
    return x @ params["w"] + params["b"]


def init_mlp(generator, sizes: Sequence[int], dtype=torch.float32,
             device=None) -> List:
    """An MLP with layer widths ``sizes`` (input first), each layer from
    :func:`init_linear` with draws from ``generator`` in turn."""
    return [init_linear(generator, n_in, n_out, dtype, device)
            for n_in, n_out in zip(sizes[:-1], sizes[1:])]


def mlp_apply(params: List, x, activation: Callable = torch.relu,
              final_activation=None, compute_dtype=None):
    """Apply an MLP: hidden layers use ``activation``, the last
    ``final_activation`` (None: linear). ``compute_dtype`` runs every
    layer's product and activation in that dtype (see
    :func:`linear_apply`); the output is cast back to the input's dtype so
    the distribution heads downstream keep full precision."""
    out_dtype = x.dtype
    for i, layer in enumerate(params):
        x = linear_apply(layer, x, compute_dtype=compute_dtype)
        if i + 1 < len(params):
            x = activation(x)
        elif final_activation is not None:
            x = final_activation(x)
    if compute_dtype is not None:
        x = x.to(out_dtype)
    return x


def init_conv(generator, kh: int, kw: int, c_in: int, c_out: int,
              dtype=torch.float32, device=None):
    """He-initialized conv layer ``{"w": [c_out, c_in, kh, kw], "b":
    [c_out]}`` (the JAX package's ``init_conv`` with its kernel in OIHW):
    ``w`` normal with std ``sqrt(2 / (kh * kw * c_in))``, ``b`` zero."""
    device = _device(device, generator)
    w = torch.randn((c_out, c_in, kh, kw), generator=generator, dtype=dtype,
                    device=device) * math.sqrt(2.0 / (kh * kw * c_in))
    return {"w": w.requires_grad_(True),
            "b": torch.zeros(c_out, dtype=dtype,
                             device=device).requires_grad_(True)}


def _same_pads(size: int, k: int, stride: int) -> Tuple[int, int]:
    """``lax``'s "SAME" padding of a strided convolution: the output has
    ``ceil(size / stride)`` positions and the extra row, when the total is
    odd, goes after."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _transpose_pads(k: int, stride: int, padding: str) -> Tuple[int, int]:
    """``lax.conv_transpose``'s padding of the dilated input
    (``jax/_src/lax/convolution.py::_conv_transpose_padding``)."""
    if padding == "SAME":
        pad_len = k + stride - 2
        pad_a = k - 1 if stride > k - 1 else -(-pad_len // 2)
    elif padding == "VALID":
        pad_len = k + stride - 2 + max(k - stride, 0)
        pad_a = k - 1
    else:
        raise ValueError("padding must be 'SAME' or 'VALID'; got {!r}."
                         .format(padding))
    return pad_a, pad_len - pad_a


def _nchw(x, dtype):
    """``[..., H, W, C]`` as an NCHW view ``[N, C, H, W]`` (channels-last
    in memory) and the leading axes."""
    lead = tuple(x.shape[:-3])
    x2 = x.reshape((-1,) + tuple(x.shape[-3:])).to(dtype)
    return x2.permute(0, 3, 1, 2), lead


def _nhwc(out, lead, bias):
    out = out.permute(0, 2, 3, 1) + bias
    return out.reshape(lead + tuple(out.shape[1:]))


def conv_apply(params, x, stride=1, padding="SAME"):
    """2-D convolution of ``x: [..., H, W, C]`` (leading axes batched),
    ``lax.conv_general_dilated`` with NHWC/HWIO/NHWC and ``padding``
    "SAME" or "VALID" (``examples/utils/nn.py:89-98``). "SAME" pads
    as ``lax`` does: an odd total puts the extra row and column after, by
    an explicit ``F.pad``."""
    w = params["w"]
    kh, kw = w.shape[-2:]
    x2, lead = _nchw(x, w.dtype)
    if padding == "SAME":
        (top, bottom) = _same_pads(x2.shape[2], kh, stride)
        (left, right) = _same_pads(x2.shape[3], kw, stride)
        if top == bottom and left == right:
            pad = (top, left)
        else:
            x2 = torch.nn.functional.pad(x2, (left, right, top, bottom))
            pad = 0
    elif padding == "VALID":
        pad = 0
    else:
        raise ValueError("padding must be 'SAME' or 'VALID'; got {!r}."
                         .format(padding))
    out = torch.nn.functional.conv2d(x2, w, stride=stride, padding=pad)
    return _nhwc(out, lead, params["b"])


def deconv_apply(params, x, stride=2, padding="SAME"):
    """2-D transposed convolution of ``x: [..., H, W, C]``:
    ``lax.conv_transpose`` with NHWC/HWIO/NHWC and ``transpose_kernel=
    False`` (``examples/utils/nn.py:101-113``; reference
    ``examples/utils/utils.py:74``).

    ``lax`` dilates the input by ``stride``, pads it by
    :func:`_transpose_pads` and correlates it with the kernel as it is,
    input channels first (HWIO with I the input's channels). Torch's
    ``conv_transpose2d`` correlates the dilated input with the kernel
    flipped in space, its weight ``[in, out, kh, kw]``, after ``k - 1 -
    padding`` rows each side and ``output_padding`` more after. So the
    layer's OIHW kernel ``[c_out, c_in, kh, kw]`` goes in transposed to
    ``[c_in, c_out]`` and flipped, ``padding = k - 1 - pad_before``, and a
    larger ``pad_after`` is the ``output_padding``; a smaller one (an odd
    "SAME" total) is cut from the end of the output."""
    w = params["w"]
    kh, kw = w.shape[-2:]
    x2, lead = _nchw(x, w.dtype)
    (top, bottom) = _transpose_pads(kh, stride, padding)
    (left, right) = _transpose_pads(kw, stride, padding)
    weight = torch.flip(w, (2, 3)).transpose(0, 1)
    out = torch.nn.functional.conv_transpose2d(
        x2, weight, stride=stride, padding=(kh - 1 - top, kw - 1 - left),
        output_padding=(max(bottom - top, 0), max(right - left, 0)))
    if bottom < top or right < left:
        out = out[:, :, :out.shape[2] - max(top - bottom, 0),
                  :out.shape[3] - max(left - right, 0)]
    return _nhwc(out, lead, params["b"])


def _is_conv_kernel(path, a):
    return path and path[-1] == "w" and np.ndim(a) == 4


def _map_with_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def params_from_numpy(tree, device=None, dtype=None):
    """A tree of leaf tensors that require grad from a nested dict/list
    tree of arrays (e.g. the JAX package's parameters as numpy), on
    ``device`` (the card when None) in ``dtype`` (the arrays' own when
    None). A 4-D ``"w"`` is a conv kernel: HWIO becomes OIHW."""
    device = torch.device("cuda", 0) if device is None \
        else torch.device(device)

    def leaf(path, a):
        a = np.array(a)
        if _is_conv_kernel(path, a):
            a = np.ascontiguousarray(a.transpose(3, 2, 0, 1))
        return torch.tensor(a, dtype=dtype,
                            device=device).requires_grad_(True)

    return _map_with_path(leaf, tree)


def params_to_numpy(tree):
    """The tree with every tensor as a numpy array (on the host); a conv
    kernel goes back to HWIO."""
    def leaf(path, t):
        a = t.detach().cpu().numpy()
        if _is_conv_kernel(path, a):
            a = np.ascontiguousarray(a.transpose(2, 3, 1, 0))
        return a

    return _map_with_path(leaf, tree)


def _device(device, generator):
    if device is not None:
        return torch.device(device)
    return generator.device
