"""The Zamba2 Mamba layer's glue ops (``kernels/mamba2_glue.py``) on the CPU.

Each plain version against the model's expression as it was written before
the glue became ops (copied here verbatim), bit for bit, at zamba2-7b's
widths (d 3584, 112 heads, two B/C groups) and zamba2-2.7b's (80 heads, one
group), with and without a carried conv tail; the ops' dispatch ('cuda'
refuses CPU tensors and autograd, 'torch' runs the plain version); and the
model's forward, decode step and slot prefill under ``impl=kernels.plain``,
in both zamba2 forms, against the same model assembled from the old
expressions, bit for bit; and the rule the norm kernels are held to on the
card (``glue_common.one_inv_a_row``).  The kernels themselves run on the
card only
(``tests/test_torch_kernels_cuda.py``).
"""
import pytest
import torch
import torch.nn.functional as F

from repro_torch.configs import get_config
from repro_torch.distributed import local
from repro_torch.kernels import KERNELS, MAMBA2_GLUE, mamba2_glue, ops, plain
from repro_torch.kernels.glue_common import one_inv_a_row
from repro_torch.models import layers as L
from repro_torch.models import reduced
from repro_torch.models import zamba2 as Z
from repro_torch.models.tree import leaves

CONV_K = 4
# (d, heads, groups, eps): zamba2-7b's and zamba2-2.7b's Mamba widths
WIDTHS = {"zamba2-7b": (3584, 112, 2, 1e-5), "zamba2-2.7b": (2560, 80, 1,
                                                             1e-6)}
P = N = 64
LENGTHS = [1, 5, 37]
DTYPES = [torch.bfloat16, torch.float32]


@pytest.fixture(autouse=True)
def _one_thread():
    """One CPU thread: ATen splits a large elementwise op into a chunk a
    thread, each with a scalar tail whose exp rounds unlike the vector
    body's, so two evaluations of one expression can differ in an ulp when
    the machine hands the op fewer threads one time than the other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _randn(gen, *shape, dtype, scale=1.0, shift=0.0):
    return (torch.randn(shape, generator=gen) * scale + shift).to(dtype)


# -- the expressions as the model wrote them before -------------------------

def _old_gated_norm(y, z, w, eps=1e-6, groups=1):
    g = y * F.silu(z)
    if groups > 1:
        parts = (*g.shape[:-1], groups, g.shape[-1] // groups)
        return L.rms_norm(g.reshape(parts), w.reshape(parts[-2:]),
                          eps=eps).reshape(g.shape)
    if local.tp_group() is None:
        return L.rms_norm(g, w, eps=eps)
    gf = g.float()
    ss = local.reduce_partial(torch.sum(gf * gf, dim=-1, keepdim=True))
    var = ss / (gf.shape[-1] * local.tp_degree())
    return (gf * torch.rsqrt(var + eps) * w.float()).to(g.dtype)


def _old_causal_conv(x, w, b, tail=None):
    if tail is None:
        tail = x.new_zeros((x.shape[0], CONV_K - 1, x.shape[2]))
    ext = torch.cat([tail, x], dim=1)                 # (B, S+K-1, C)
    s = x.shape[1]
    y = sum(ext[:, i:i + s] * w[i] for i in range(CONV_K)) + b
    return F.silu(y), ext[:, -(CONV_K - 1):]


def _old_mamba_block(p, cfg, x, tp, impl, state=None, t=None):
    bsz, s, _ = x.shape
    _, h, n = Z._dims(cfg, tp)
    h //= local.tp_degree()                           # this rank's heads
    ph = cfg.ssm_head_dim
    hp = h * ph
    grp = cfg.ssm_groups
    gn = grp * n                                      # B (and C) columns
    st = state or {}

    xn = L.rms_norm(x if t is None else x + t, p["ln"], eps=cfg.norm_eps)
    w = p["in_proj"]
    if local.tp_group() is None:
        zxbcdt = xn @ w
    else:
        # column-parallel z | x | dt; B | C a replicated product
        zx = local.column_in(xn) @ torch.cat([w[:, :2 * hp], w[:, -h:]], -1)
        zxbcdt = torch.cat([zx[..., :2 * hp], xn @ w[:, 2 * hp:-h],
                            zx[..., 2 * hp:]], -1)
    z = zxbcdt[..., :hp]
    xbc = zxbcdt[..., hp:hp + hp + 2 * gn]
    dt_raw = zxbcdt[..., -h:]

    xbc, new_tail = _old_causal_conv(xbc, p["conv_w"], p["conv_b"],
                                     st.get("conv"))
    xs = xbc[..., :hp].reshape(bsz, s, h, ph)
    # (B, S, G, N); one group is read by this rank's heads only
    bmat = local.copy_to_model(xbc[..., hp:hp + gn]).reshape(bsz, s, grp, n)
    cmat = local.copy_to_model(xbc[..., hp + gn:]).reshape(bsz, s, grp, n)

    dt = F.softplus(dt_raw.float() + p["dt_bias"])
    log_decay = -dt * torch.exp(p["a_log"])           # (B, S, H) <= 0
    x_scaled = (xs.float() * dt[..., None]).to(x.dtype)

    if s == 1:
        # decode fast path: one SSD recurrence step
        h0 = st.get("ssd")
        if h0 is None:
            h0 = torch.zeros((bsz, h, n, ph), device=x.device)
        xf = x_scaled[:, 0].float()
        bf, cf = (z[:, 0].float().repeat_interleave(h // z.shape[2], dim=1)
                  for z in (bmat, cmat))
        h1 = torch.exp(log_decay[:, 0])[..., None, None] * h0 \
            + bf[..., :, None] * xf[..., None, :]
        y = torch.einsum("bhn,bhnp->bhp", cf, h1)[:, None].to(x.dtype)
        new_ssd = h1
    else:
        y, new_ssd = L.op(impl, "mamba2")(x_scaled, log_decay.to(x.dtype),
                                          bmat, cmat, st.get("ssd"))

    y = y + xs * p["d_skip"].to(x.dtype)[None, None, :, None]
    y = y.reshape(bsz, s, hp)
    y = _old_gated_norm(y, z, p["norm"], cfg.norm_eps, grp)
    return x + local.row_out(y @ p["out_proj"]), {"conv": new_tail,
                                                  "ssd": new_ssd}


# -- each plain version against the old expression --------------------------

def _layer_inputs(arch, s, dtype, carried, seed=0, b=2):
    """A layer's glue inputs at ``arch``'s widths: in_proj's output
    [z | x | B | C | dt] (dt_raw wide enough that softplus's threshold of
    20 bites), the conv's weights and tail, dt_bias, a_log."""
    _, h, g, eps = WIDTHS[arch]
    hp, gn = h * P, g * N
    c = hp + 2 * gn
    gen = torch.Generator().manual_seed(seed)
    zx = _randn(gen, b, s, 2 * hp + 2 * gn + h, dtype=dtype, scale=2.0)
    zx[..., -h:] = _randn(gen, b, s, h, dtype=dtype, scale=8.0)
    zx[:, 0, -1] = 24.0
    return {"zxbcdt": zx, "conv_w": _randn(gen, CONV_K, c, dtype=dtype,
                                           scale=0.3),
            "conv_b": _randn(gen, c, dtype=dtype, scale=0.1),
            "dt_bias": torch.randn(h, generator=gen) * 0.5,
            "a_log": torch.rand(h, generator=gen) * 2.7,
            "tail": (_randn(gen, b, CONV_K - 1, c, dtype=dtype, scale=2.0)
                     if carried else None),
            "dims": (hp, gn, h, g, eps)}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("s", LENGTHS)
@pytest.mark.parametrize("arch", list(WIDTHS))
def test_conv_in_plain_is_the_models_expression(arch, s, carried, dtype):
    ins = _layer_inputs(arch, s, dtype, carried)
    hp, gn, h, g, _ = ins.pop("dims")
    zxbcdt = ins["zxbcdt"]
    bsz = zxbcdt.shape[0]
    decay_dtype = torch.float32 if s == 1 else dtype
    got = plain.mamba2_conv_in(*ins.values(), decay_dtype, g)
    xbc = zxbcdt[..., hp:hp + hp + 2 * gn]
    dt_raw = zxbcdt[..., -h:]
    xbc, new_tail = _old_causal_conv(xbc, ins["conv_w"], ins["conv_b"],
                                     ins["tail"])
    xs = xbc[..., :hp].reshape(bsz, s, h, P)
    bmat = xbc[..., hp:hp + gn].reshape(bsz, s, g, N)
    cmat = xbc[..., hp + gn:].reshape(bsz, s, g, N)
    dt = F.softplus(dt_raw.float() + ins["dt_bias"])
    log_decay = -dt * torch.exp(ins["a_log"])
    x_scaled = (xs.float() * dt[..., None]).to(dtype)
    want = (xs, x_scaled, bmat, cmat, log_decay.to(decay_dtype), new_tail)
    assert bool((dt_raw.float() + ins["dt_bias"] > 20).any())
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("hybrid", [False, True])
@pytest.mark.parametrize("s", LENGTHS)
@pytest.mark.parametrize("arch", list(WIDTHS))
def test_norm_in_plain_is_the_models_expression(arch, s, hybrid, dtype):
    d, _, _, eps = WIDTHS[arch]
    gen = torch.Generator().manual_seed(1)
    x = _randn(gen, 2, s, d, dtype=dtype, scale=3.0)
    t = _randn(gen, 2, s, d, dtype=dtype) if hybrid else None
    ln = _randn(gen, d, dtype=dtype, scale=0.1, shift=1.0)
    got = plain.mamba2_norm_in(x, t, ln, eps)
    want = L.rms_norm(x if t is None else x + t, ln, eps=eps)
    assert got.dtype == dtype and torch.equal(got, want)


def _gate_inputs(arch, s, dtype, seed=2):
    _, h, g, eps = WIDTHS[arch]
    hp = h * P
    gen = torch.Generator().manual_seed(seed)
    zx = _randn(gen, 2, s, 2 * hp + 2 * g * N + h, dtype=dtype, scale=2.0)
    return (_randn(gen, 2, s, h, P, dtype=dtype),
            _randn(gen, 2, s, h, P, dtype=dtype, scale=2.0), zx[..., :hp],
            torch.randn(h, generator=gen) * 0.5 + 1.0,
            _randn(gen, hp, dtype=dtype, scale=0.1, shift=1.0), g, eps)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("s", LENGTHS)
@pytest.mark.parametrize("arch", list(WIDTHS))
def test_gate_out_plain_is_the_models_expression(arch, s, dtype):
    y, xs, z, d_skip, norm_w, g, eps = _gate_inputs(arch, s, dtype)
    got = plain.mamba2_gate_out(y, xs, z, d_skip, norm_w, g, eps)
    b, _, h, ph = y.shape
    want = y + xs * d_skip.to(dtype)[None, None, :, None]
    want = _old_gated_norm(want.reshape(b, s, h * ph), z, norm_w, eps, g)
    assert got.dtype == dtype and torch.equal(got, want)


# -- dispatch ---------------------------------------------------------------

def _op_args(dtype=torch.float32, grad=False, ph=8):
    """Small arguments of every glue op, by name: 4 heads of ``ph`` in two
    groups of N 8, a tail carried, d = 2 ph + 4 (with ``ph`` not a multiple
    of 8, a head and d in bfloat16 are off the kernels' 16-byte
    vectors)."""
    gen = torch.Generator().manual_seed(5)
    b, s, h, g, n = 2, 3, 4, 2, 8
    hp, gn = h * ph, g * n
    c, d = hp + 2 * gn, 2 * ph + 4

    def r(*shape, **kw):
        return _randn(gen, *shape, dtype=dtype, **kw).requires_grad_(grad)

    def f(*shape):
        return torch.randn(shape, generator=gen).requires_grad_(grad)
    zx = r(b, s, hp + c + h)
    return {
        "mamba2_norm_in": (r(b, s, d), r(b, s, d), r(d), 1e-5),
        "mamba2_conv_in": (zx, r(CONV_K, c), r(c), f(h), f(h),
                           r(b, CONV_K - 1, c), dtype, g),
        "mamba2_gate_out": (r(b, s, h, ph), r(b, s, h, ph), zx[..., :hp],
                            f(h), r(hp), g, 1e-5),
    }


@pytest.mark.parametrize("groups", [1, 2])
def test_one_inv_a_row_tells_a_sums_order_from_a_fault(groups):
    """``glue_common.one_inv_a_row``, the rule the norm kernels are held to
    on the card: the plain norm passes, and so does one whose normalizer
    moved a few float32 ulps (another order of the sum of squares); a
    normalizer 1% off, or one value moved by a bfloat16 ulp, does not."""
    gen = torch.Generator().manual_seed(5)
    rows, width, eps = 7, 64 * groups, 1e-5
    pre = _randn(gen, rows, width, dtype=torch.bfloat16, scale=3.0)
    w = _randn(gen, width, dtype=torch.bfloat16, scale=0.1, shift=1.0)
    f = pre.float().reshape(rows, groups, 64)
    inv = torch.rsqrt(torch.mean(f * f, dim=-1, keepdim=True) + eps)

    def normed(c):
        return ((f * c) * w.float().reshape(groups, 64)).to(
            torch.bfloat16).reshape(rows, width)
    moved = inv
    for _ in range(3):
        moved = torch.nextafter(moved, torch.full_like(moved, 1.0e9))
    assert one_inv_a_row(normed(inv), pre, w, eps, groups)
    assert one_inv_a_row(normed(moved), pre, w, eps, groups)
    assert not one_inv_a_row(normed(inv * 1.01), pre, w, eps, groups)
    bad = normed(inv)
    bad.view(torch.int16)[3, 5] += 1
    assert not one_inv_a_row(bad, pre, w, eps, groups)


def test_glue_ops_are_kernels_with_launch_counts():
    assert [k.__name__ for k in MAMBA2_GLUE] == list(_op_args())
    assert all(k in KERNELS for k in MAMBA2_GLUE)
    for k in MAMBA2_GLUE:
        assert isinstance(k.launches, int)
        assert getattr(mamba2_glue, k.__name__) is k
        assert getattr(plain, k.__name__) is getattr(mamba2_glue,
                                                     k.__name__ + "_plain")
        assert k.__name__ in plain.__all__


@pytest.mark.parametrize("name", list(_op_args()))
def test_torch_implementation_runs_the_plain_version(name):
    args = _op_args()[name]
    got = getattr(ops, name)(*args, implementation="torch")
    want = getattr(plain, name)(*args)
    got, want = ((got,), (want,)) if torch.is_tensor(want) else (got, want)
    assert len(got) == len(want)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("name", list(_op_args()))
def test_cuda_implementation_refuses_cpu_tensors(name):
    before = getattr(mamba2_glue, name).launches
    with pytest.raises(ValueError, match="runs on cuda tensors"):
        getattr(ops, name)(*_op_args()[name], implementation="cuda")
    with pytest.raises(ValueError, match="implementation must be one of"):
        getattr(ops, name)(*_op_args()[name], implementation="xla")
    assert getattr(mamba2_glue, name).launches == before


@pytest.mark.parametrize("name", list(_op_args()))
def test_cuda_implementation_refuses_autograd(name):
    args = _op_args(grad=True)[name]
    with pytest.raises(RuntimeError, match="has no backward"):
        getattr(ops, name)(*args, implementation="cuda")
    # under no_grad the refusal is the device's, not autograd's
    with torch.no_grad(), pytest.raises(ValueError,
                                        match="runs on cuda tensors"):
        getattr(ops, name)(*args, implementation="cuda")
    # the plain version differentiates
    out = getattr(plain, name)(*args)
    out = out if torch.is_tensor(out) else out[1]
    out.float().sum().backward()


def _misaligned(t):
    """t's values, contiguous, one element past a 16-byte boundary."""
    if not torch.is_tensor(t):
        return t
    buf = torch.empty(t.numel() + 1, dtype=t.dtype)
    buf[1:] = t.flatten()
    return buf[1:].view(t.shape)


@pytest.mark.parametrize("fault", ["rows", "address"])
@pytest.mark.parametrize("name", list(_op_args()))
def test_kernels_refuse_operands_off_the_16_byte_vectors(name, fault):
    """The kernels move whole 16-byte vectors and have no other route:
    heads of 12 bfloat16 values (rows of 28 for the norm), or operands one
    float32 past a 16-byte boundary, are refused by the wrapper before any
    launch."""
    if fault == "rows":
        args = _op_args(torch.bfloat16, ph=12)[name]
    else:
        args = [_misaligned(a) for a in _op_args()[name]]
    kern = getattr(mamba2_glue, name)
    before = kern.launches
    with pytest.raises(ValueError, match="16-byte aligned"):
        kern(*args)
    assert kern.launches == before


def test_a_compiled_caller_runs_the_wrapper_outside_its_trace():
    """The hot-path audit compiles the decode step, whose Mamba layers call
    the kernel wrappers: a traced call breaks the graph and runs the
    wrapper eagerly, where torch.compiler.is_compiling() reads False, and
    the result is the eager one; an untraced call runs it directly."""
    seen = []

    @mamba2_glue._untraced
    def kern(x, eps):
        seen.append(torch.compiler.is_compiling())
        x.data_ptr()                      # what a launch reads
        return x * 2 + eps

    def model(x):
        return kern(torch.sin(x), 1e-5).cos()

    x = torch.randn(8)
    want = model(x)
    compiled = torch.compile(model, backend="eager")
    got = [compiled(x) for _ in range(2)]
    assert all(torch.equal(g, want) for g in got)
    assert seen == [False] * 3
    assert kern.__name__ == "kern"
    assert all(k.__wrapped__.__name__ == k.__name__ for k in MAMBA2_GLUE)


def test_gate_out_reads_z_in_place_and_refuses_other_strides():
    """z is in_proj's output read in place (rows at one stride); a z whose
    rows are not at one stride is refused before any launch."""
    y, xs, z, d_skip, norm_w, g, eps = _op_args()["mamba2_gate_out"]
    assert mamba2_glue._row_stride("t", z) == z.stride(1) > z.shape[-1]
    # a decode step's xs: one row a sequence, its middle dim of one
    xbc = torch.zeros(3, 1, 40)
    xs1 = xbc[..., :32].unflatten(-1, (4, 8))
    assert mamba2_glue._row_stride("t", xs1, 2) == 40
    bad = torch.zeros(z.shape[0], z.shape[1] + 1, z.shape[2])[:, 1:]
    with pytest.raises(ValueError, match="one stride"):
        mamba2_glue.mamba2_gate_out(y, xs, bad, d_skip, norm_w, g, eps)


# -- the model, before and after ---------------------------------------------

@pytest.fixture(scope="module", params=[
    ("zamba2-2.7b", "bfloat16"), ("zamba2-2.7b", "float32"),
    ("zamba2-7b", "bfloat16"), ("zamba2-7b", "float32")],
    ids=lambda p: "-".join(p))
def model(request):
    arch, dtype = request.param
    cfg = reduced(get_config(arch), dtype=dtype)
    params = Z.init(cfg, seed=0, device="cpu")
    # a non-trivial norm, conv bias, dt bias, decay and skip, so that each
    # of the glue's terms shows
    gen = torch.Generator().manual_seed(3)
    for name, shift in (("ln", 1.0), ("norm", 1.0), ("conv_b", 0.0),
                        ("dt_bias", 0.0), ("a_log", 0.5), ("d_skip", 1.0)):
        t = params["layers"][name]
        t.copy_(torch.randn(t.shape, generator=gen) * 0.5 + shift)
    return cfg, params


def _tokens(cfg, b, s, seed):
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(0, cfg.vocab, (b, s), generator=gen)


def test_forward_unchanged_under_plain(model, monkeypatch):
    cfg, params = model
    tokens = _tokens(cfg, 2, 40, 0)
    with torch.no_grad():
        got = Z.forward(params, cfg, {"tokens": tokens}, impl=plain)
        monkeypatch.setattr(Z, "_mamba_block", _old_mamba_block)
        want = Z.forward(params, cfg, {"tokens": tokens}, impl=plain)
    assert torch.equal(got, want)


@pytest.mark.parametrize("steps", [(13, 1, 1), (7, 9), (2, 1, 2)])
def test_decode_and_slot_prefill_unchanged_under_plain(model, steps,
                                                       monkeypatch):
    """A prompt prefilled with state carried, then one-token steps (or a
    second chunk, of fewer rows than the conv's tail too): the logits and
    every cache leaf, tails included."""
    cfg, params = model
    b = 2
    new = Z.init_cache(cfg, b, 64, device="cpu")
    old = Z.init_cache(cfg, b, 64, device="cpu")
    pos = 0
    with torch.no_grad():
        for i, s in enumerate(steps):
            tokens = _tokens(cfg, b, s, 10 + i)
            got, new = Z.decode_step(params, cfg, new, tokens, [pos] * b,
                                     impl=plain)
            with monkeypatch.context() as m:
                m.setattr(Z, "_mamba_block", _old_mamba_block)
                want, old = Z.decode_step(params, cfg, old, tokens,
                                          [pos] * b, impl=plain)
            pos += s
            assert torch.equal(got, want)
            for g, w in zip(leaves(new), leaves(old)):
                assert torch.equal(g, w)
