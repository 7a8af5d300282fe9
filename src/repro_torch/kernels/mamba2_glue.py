"""The Zamba2 Mamba layer's glue: ``csrc/mamba2_glue.cu`` for CUDA tensors.

The elementwise and row-norm work around the layer's two matrix products
and the SSD, as three ops, each one kernel launch:

  mamba2_norm_in   rms_norm(x + t, ln) (t a hybrid call's output), or
                   rms_norm(x, ln)
  mamba2_conv_in   from in_proj's output, read in place: the causal conv of
                   [x | B | C] with its bias and silu, dt = softplus(dt_raw +
                   dt_bias), the log-decay -dt * exp(a_log), x scaled by dt,
                   B and C as (B, S, G, N), and the conv's new tail
  mamba2_gate_out  the D skip, silu(z) gating and the RMS norm over each of
                   ``groups`` equal parts of the inner width, times norm_w

Replaces no Pallas kernel: the JAX package leaves this glue to XLA's fusion
(``repro/models/zamba2.py``).  Each ``*_plain`` function is the model's
expression as it was written before the kernels, verbatim; the wrappers
take CUDA tensors only (float32 or bfloat16 activations with the weights in
their dtype, dt_bias, a_log and d_skip float32, rows of whole 16-byte
vectors at 16-byte-aligned addresses, as every zamba2 config's widths give)
and raise on anything else.  Each kernel rounds where its plain version
rounds and the norms sum in PyTorch's CUDA order, so every kernel gives
the plain version's bits on the card (the CUDA source says how and with
which PyTorch).  Each wrapper counts its launches
in ``<wrapper>.launches``.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from . import cuda_lib
from .glue_common import fail, rms_norm, same_dtype, stream, vectors

CONV_K = 4          # the conv's window (csrc/mamba2_glue.cu's CONV_K)
MAX_WIDTH = 8192    # a norm's row at most (csrc/mamba2_glue.cu's NORM_WIDTH:
                    # its squares in shared memory)


# ---------------------------------------------------------------------------
# Plain versions: the model's expressions, on any device, under autograd
# ---------------------------------------------------------------------------

def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 tail: torch.Tensor | None = None):
    """Depthwise causal conv, window CONV_K, by shift-and-add.  x: (B, S,
    C); tail: (B, CONV_K - 1, C), the carry for decode.  Returns (y,
    new_tail)."""
    if tail is None:
        tail = x.new_zeros((x.shape[0], CONV_K - 1, x.shape[2]))
    ext = torch.cat([tail, x], dim=1)                 # (B, S+K-1, C)
    s = x.shape[1]
    y = sum(ext[:, i:i + s] * w[i] for i in range(CONV_K)) + b
    return F.silu(y), ext[:, -(CONV_K - 1):]


def _widths(zxbcdt, conv_w, dt_bias) -> tuple[int, int, int]:
    """-> (hp, gn, h): the inner width, B's (and C's) columns and the heads
    of in_proj's output [z (hp) | x (hp) | B (gn) | C (gn) | dt (h)]."""
    h = dt_bias.shape[0]
    c = conv_w.shape[-1]
    hp = zxbcdt.shape[-1] - c - h
    return hp, (c - hp) // 2, h


def mamba2_norm_in_plain(x, t, ln, eps) -> torch.Tensor:
    """x (..., d), t like x or None, ln (d) -> rms_norm(x + t, ln)."""
    return rms_norm(x if t is None else x + t, ln, eps=eps)


def mamba2_conv_in_plain(zxbcdt, conv_w, conv_b, dt_bias, a_log, tail,
                         decay_dtype, groups) -> tuple:
    """zxbcdt (B, S, 2 hp + 2 gn + h), in_proj's output; conv_w (4, hp + 2
    gn), conv_b (hp + 2 gn); dt_bias, a_log (h) float32; tail (B, 3, hp + 2
    gn) or None -> (xs, x_scaled (B, S, h, hp / h), b, c (B, S, groups, gn
    / groups), log_decay (B, S, h) in ``decay_dtype``, new_tail)."""
    hp, gn, h = _widths(zxbcdt, conv_w, dt_bias)
    bsz, s, _ = zxbcdt.shape
    xbc = zxbcdt[..., hp:hp + hp + 2 * gn]
    dt_raw = zxbcdt[..., -h:]

    xbc, new_tail = _causal_conv(xbc, conv_w, conv_b, tail)
    xs = xbc[..., :hp].reshape(bsz, s, h, hp // h)
    bmat = xbc[..., hp:hp + gn].reshape(bsz, s, groups, gn // groups)
    cmat = xbc[..., hp + gn:].reshape(bsz, s, groups, gn // groups)

    dt = F.softplus(dt_raw.float() + dt_bias)
    log_decay = -dt * torch.exp(a_log)                # (B, S, H) <= 0
    x_scaled = (xs.float() * dt[..., None]).to(zxbcdt.dtype)
    return xs, x_scaled, bmat, cmat, log_decay.to(decay_dtype), new_tail


def _gated(y, xs, z, d_skip) -> torch.Tensor:
    """(y + xs * D) * silu(z), the gated norm's input, (B, S, H*P)."""
    bsz, s, h, ph = y.shape
    y = y + xs * d_skip.to(xs.dtype)[None, None, :, None]
    y = y.reshape(bsz, s, h * ph)
    return y * F.silu(z)


def mamba2_gate_out_plain(y, xs, z, d_skip, norm_w, groups,
                          eps) -> torch.Tensor:
    """y, xs (B, S, H, P), z (B, S, H*P), d_skip (H) float32, norm_w (H*P)
    -> rms_norm((y + xs * D) * silu(z), norm_w) over each of ``groups``
    equal parts of H*P (``Zamba2RMSNormGated``), (B, S, H*P)."""
    g = _gated(y, xs, z, d_skip)
    if groups > 1:
        parts = (*g.shape[:-1], groups, g.shape[-1] // groups)
        return rms_norm(g.reshape(parts), norm_w.reshape(parts[-2:]),
                        eps=eps).reshape(g.shape)
    return rms_norm(g, norm_w, eps=eps)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _row_stride(name: str, t: torch.Tensor, row_dims: int = 1) -> int:
    """The stride between t's rows, each its last ``row_dims`` dims stored
    contiguous, one row after another at one stride: in_proj's output (or
    the conv's) read in place."""
    row = t.shape[t.dim() - row_dims:]
    try:
        rows = t.view(-1, *row)
    except RuntimeError:        # the leading dims are not at one stride
        rows = None
    if rows is None or not rows[0].is_contiguous():
        fail(name, f"reads rows at one stride, each contiguous, got "
             f"strides {t.stride()} of {tuple(t.shape)}")
    return rows.stride(0) if rows.shape[0] > 1 else rows[0].numel()


def _norm_width(name: str, width: int) -> None:
    if not 1 <= width <= MAX_WIDTH:
        fail(name, f"norms rows of 1 to {MAX_WIDTH} values, not {width}")


def _untraced(fn):
    """``fn``, which a torch.compile trace does not enter (the hot-path
    audit compiles the decode step): dynamo cannot read the raw CUDA stream
    a launch takes, so a traced call breaks the graph here and runs the
    kernel eagerly.  Untraced, one flag read; only a trace, which has
    imported dynamo already, builds the disabled function."""
    disabled = []

    @functools.wraps(fn)
    def wrapper(*args):
        if not torch.compiler.is_compiling():
            return fn(*args)
        if not disabled:
            disabled.append(torch.compiler.disable(fn))
        return disabled[0](*args)
    return wrapper


@_untraced
def mamba2_norm_in(x: torch.Tensor, t: torch.Tensor | None, ln: torch.Tensor,
                   eps: float) -> torch.Tensor:
    """:func:`mamba2_norm_in_plain` in one launch."""
    name = "mamba2_norm_in"
    d = x.shape[-1] if x.dim() else 0
    if x.dim() < 1 or ln.shape != (d,) or x.numel() < 1 \
            or (t is not None and t.shape != x.shape):
        fail(name, f"shapes x {tuple(x.shape)}, t "
             f"{None if t is None else tuple(t.shape)}, ln "
             f"{tuple(ln.shape)}")
    ts = (x, ln) if t is None else (x, t, ln)
    code = same_dtype(name, x.dtype, *ts)
    vectors(name, d, *ts)
    _norm_width(name, d)
    cuda_lib.check_operands(*ts)
    out = torch.empty_like(x)
    rc = cuda_lib.library().hasco_mamba2_norm_in(
        x.data_ptr(), None if t is None else t.data_ptr(), ln.data_ptr(),
        out.data_ptr(), x.numel() // d, d, eps, code, stream())
    cuda_lib.check(rc, name)
    mamba2_norm_in.launches += 1
    return out


@_untraced
def mamba2_conv_in(zxbcdt: torch.Tensor, conv_w: torch.Tensor,
                   conv_b: torch.Tensor, dt_bias: torch.Tensor,
                   a_log: torch.Tensor, tail: torch.Tensor | None,
                   decay_dtype: torch.dtype, groups: int) -> tuple:
    """:func:`mamba2_conv_in_plain` in one launch; ``decay_dtype`` is
    zxbcdt's or float32."""
    name = "mamba2_conv_in"
    if zxbcdt.dim() != 3 or conv_w.dim() != 2 or dt_bias.dim() != 1:
        fail(name, f"zxbcdt {tuple(zxbcdt.shape)} is not (B, S, W), or "
             f"conv_w {tuple(conv_w.shape)}, dt_bias "
             f"{tuple(dt_bias.shape)}")
    bsz, s, width = zxbcdt.shape
    hp, gn, h = _widths(zxbcdt, conv_w, dt_bias)
    c = conv_w.shape[1]
    if conv_w.shape[0] != CONV_K or conv_b.shape != (c,) \
            or a_log.shape != (h,) or min(bsz, s, h, hp, gn, groups) < 1 \
            or hp % h or c != hp + 2 * gn or gn % groups or bsz > 65535 \
            or (tail is not None and tail.shape != (bsz, CONV_K - 1, c)):
        fail(name, f"shapes zxbcdt {tuple(zxbcdt.shape)}, conv_w "
             f"{tuple(conv_w.shape)}, conv_b {tuple(conv_b.shape)}, "
             f"dt_bias {tuple(dt_bias.shape)}, a_log {tuple(a_log.shape)}, "
             f"tail {None if tail is None else tuple(tail.shape)}, groups "
             f"{groups}")
    if decay_dtype not in (zxbcdt.dtype, torch.float32):
        raise TypeError(f"{name} writes the decay in {zxbcdt.dtype} or "
                        f"float32, not {decay_dtype}")
    if tail is not None and tail.dtype == torch.bfloat16 \
            and zxbcdt.dtype == torch.float32:
        # a bfloat16 cache (the config's dtype) carried into float32
        # weights' activations: the plain version promotes it, exactly
        tail = tail.float()
    ts = (zxbcdt, conv_w, conv_b) + (() if tail is None else (tail,))
    code = same_dtype(name, zxbcdt.dtype, *ts)
    same_dtype(name, torch.float32, dt_bias, a_log)
    ph = hp // h
    vec = 16 // zxbcdt.element_size()
    if hp % vec or gn % vec or ph % vec:
        fail(name, f"takes widths of whole 16-byte vectors at 16-byte "
             f"aligned addresses: hp {hp}, B/C {gn}, a head {ph}")
    vectors(name, width, *ts)
    cuda_lib.check_operands(*ts, dt_bias, a_log)
    dev, dt = zxbcdt.device, zxbcdt.dtype
    # the conv's output [xs | B | C], whose views the plain version returns
    xbc = torch.empty((bsz, s, c), dtype=dt, device=dev)
    x_scaled = torch.empty((bsz, s, h, ph), dtype=dt, device=dev)
    log_decay = torch.empty((bsz, s, h), dtype=decay_dtype, device=dev)
    new_tail = torch.empty((bsz, CONV_K - 1, c), dtype=dt, device=dev)
    rc = cuda_lib.library().hasco_mamba2_conv_in(
        zxbcdt.data_ptr(), width, hp, c, h, ph, conv_w.data_ptr(),
        conv_b.data_ptr(), dt_bias.data_ptr(), a_log.data_ptr(),
        None if tail is None else tail.data_ptr(), xbc.data_ptr(),
        x_scaled.data_ptr(), log_decay.data_ptr(), new_tail.data_ptr(), bsz,
        s, code, cuda_lib.dtype_code(decay_dtype), stream())
    cuda_lib.check(rc, name)
    mamba2_conv_in.launches += 1
    groups_n = (groups, gn // groups)
    return (xbc[..., :hp].unflatten(-1, (h, ph)), x_scaled,
            xbc[..., hp:hp + gn].unflatten(-1, groups_n),
            xbc[..., hp + gn:].unflatten(-1, groups_n), log_decay, new_tail)


@_untraced
def mamba2_gate_out(y: torch.Tensor, xs: torch.Tensor, z: torch.Tensor,
                    d_skip: torch.Tensor, norm_w: torch.Tensor, groups: int,
                    eps: float) -> torch.Tensor:
    """:func:`mamba2_gate_out_plain` in one launch; xs and z may be the
    conv's and in_proj's outputs read in place (rows at one stride)."""
    name = "mamba2_gate_out"
    if y.dim() != 4:
        fail(name, f"y {tuple(y.shape)} is not (B, S, H, P)")
    bsz, s, h, ph = y.shape
    hp = h * ph
    if xs.shape != y.shape or z.shape != (bsz, s, hp) \
            or d_skip.shape != (h,) or norm_w.shape != (hp,) \
            or min(bsz, s, h, ph, groups) < 1 or hp % groups:
        fail(name, f"shapes y {tuple(y.shape)}, xs {tuple(xs.shape)}, z "
             f"{tuple(z.shape)}, d_skip {tuple(d_skip.shape)}, norm_w "
             f"{tuple(norm_w.shape)}, groups {groups}")
    code = same_dtype(name, y.dtype, y, xs, z, norm_w)
    same_dtype(name, torch.float32, d_skip)
    ld_x, ld_z = _row_stride(name, xs, 2), _row_stride(name, z)
    vec = 16 // y.element_size()
    if ph % vec or ld_x % vec or ld_z % vec:
        fail(name, f"takes heads and rows of whole 16-byte vectors at "
             f"16-byte aligned addresses: a head {ph}, xs's and z's row "
             f"strides {ld_x}, {ld_z}")
    vectors(name, hp // groups, y, xs, z, norm_w)
    _norm_width(name, hp // groups)
    cuda_lib.check_operands(y, norm_w, d_skip)
    cuda_lib.check_operands(y, xs, z, contiguous=False)
    out = torch.empty((bsz, s, hp), dtype=y.dtype, device=y.device)
    rc = cuda_lib.library().hasco_mamba2_gate_out(
        y.data_ptr(), xs.data_ptr(), ld_x, z.data_ptr(), ld_z,
        d_skip.data_ptr(), norm_w.data_ptr(), out.data_ptr(), bsz * s, hp,
        groups, ph, eps, code, stream())
    cuda_lib.check(rc, name)
    mamba2_gate_out.launches += 1
    return out


GLUE = (mamba2_norm_in, mamba2_conv_in, mamba2_gate_out)
for _k in GLUE:
    _k.launches = 0
