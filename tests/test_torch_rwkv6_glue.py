"""The rwkv6 block's glue ops (``kernels/rwkv6_glue.py``) on the CPU.

Each plain version against the model's expression as it was written before
the glue became ops (copied here verbatim), bit for bit; the ops' dispatch
('cuda' refuses CPU tensors and autograd, 'torch' runs the plain version);
and the model's forward, decode step and slot prefill under
``impl=kernels.plain`` against the same model assembled from the old
expressions, bit for bit.  The kernels themselves run on the card only
(``tests/test_torch_kernels_cuda.py``).
"""
import pytest
import torch
import torch.nn.functional as F

from repro_torch.configs import get_config
from repro_torch.distributed import local
from repro_torch.kernels import GLUE, KERNELS, ops, plain, rwkv6_glue
from repro_torch.models import layers as L
from repro_torch.models import reduced, rwkv6
from repro_torch.models.tree import layer, leaves

SHAPES = [(1, 37, 2560), (2, 5, 256), (2, 1, 256)]
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

def _old_shift(x, prev):
    if x.shape[1] == 1 and prev is not None:
        return prev[:, None, :]
    pad = torch.zeros_like(x[:, :1]) if prev is None else prev[:, None, :]
    return torch.cat([pad, x[:, :-1]], dim=1)


def _old_time_mix(p, cfg, x, tp, impl, wkv_state=None, shift_prev=None):
    b, s, _ = x.shape
    dh = cfg.rwkv_head_dim
    h = rwkv6._heads(cfg, tp) // local.tp_degree()
    xp = _old_shift(x, shift_prev)
    mu = p["mu"].to(x.dtype)
    xr, xk, xv, xg, xw = (x + (xp - x) * mu[i] for i in range(5))
    col = local.column_in

    r = (col(xr) @ p["wr"]).reshape(b, s, h, dh)
    k = (col(xk) @ p["wk"]).reshape(b, s, h, dh)
    v = (col(xv) @ p["wv"]).reshape(b, s, h, dh)
    g = F.silu(col(xg) @ p["wg"])
    lora = col(torch.tanh(xw @ p["w_lora_a"])) @ p["w_lora_b"]
    logw = -torch.exp(torch.clamp((p["w0"] + lora).float(), -8.0, 6.0))
    logw = logw.reshape(b, s, h, dh)

    if s == 1:
        st = wkv_state if wkv_state is not None else torch.zeros(
            (b, h, dh, dh), device=x.device)
        r1, k1, v1 = (z[:, 0].float() for z in (r, k, v))
        kv = k1[..., :, None] * v1[..., None, :]
        u_f = p["u"].float()
        o1 = torch.einsum("bhk,bhkv->bhv", r1, st + u_f[None, :, :, None] * kv)
        new_state = torch.exp(logw[:, 0])[..., None] * st + kv
        out = o1[:, None].to(x.dtype)
    else:
        out, new_state = L.op(impl, "rwkv6")(r, k, v, logw.to(x.dtype),
                                             p["u"], wkv_state)
    out = L.rms_norm(out, p["ln_x"])
    out = out.reshape(b, s, h * dh) * g
    return local.row_out(out @ p["wo"]), new_state, x[:, -1]


def _old_channel_mix(p, x, shift_prev=None):
    xp = _old_shift(x, shift_prev)
    mu = p["mu_c"].to(x.dtype)
    xk = x + (xp - x) * mu[0]
    xr = x + (xp - x) * mu[1]
    hidden = torch.square(F.relu(local.column_in(xk) @ p["wck"]))
    rec = local.gather_from_model(
        torch.sigmoid(local.column_in(xr) @ p["wcr"]), -1)
    return rec * local.row_out(hidden @ p["wcv"]), x[:, -1]


def _old_block(p, cfg, x, impl, state=None):
    st = state or {}
    att, wkv, sh_t = _old_time_mix(p, cfg, L.rms_norm(x, p["ln1"]), 1, impl,
                                   st.get("wkv"), st.get("shift_t"))
    x = x + att
    cm, sh_c = _old_channel_mix(p, L.rms_norm(x, p["ln2"]),
                                st.get("shift_c"))
    return x + cm, {"wkv": wkv, "shift_t": sh_t, "shift_c": sh_c}


def _old_run(params, cfg, tokens, cache=None):
    """The old forward (``cache`` None) or decode step (the cache written
    in place)."""
    x = L.embed(params["embed"], tokens)
    for i in range(cfg.n_layers):
        p = {k: v[i] for k, v in params["layers"].items()}
        st = None if cache is None else layer(cache, i)
        x, new = _old_block(p, cfg, x, plain, state=st)
        if st is not None:
            for name, t in new.items():
                st[name].copy_(t)
    x = L.rms_norm(x, params["final_norm"])
    return L.unembed(params["head"], x, cfg.vocab)


# -- each plain version against the old expression --------------------------

def _mix_inputs(shape, dtype, carried, seed=0):
    b, t, d = shape
    gen = torch.Generator().manual_seed(seed)
    x = _randn(gen, b, t, d, dtype=dtype, scale=3.0)
    ln = _randn(gen, d, dtype=dtype, scale=0.1, shift=1.0)
    prev = _randn(gen, b, d, dtype=dtype) if carried else None
    return gen, x, ln, prev


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_time_in_plain_is_the_models_expression(shape, carried, dtype):
    gen, x, ln, prev = _mix_inputs(shape, dtype, carried)
    mu = _randn(gen, 5, shape[2], dtype=dtype, scale=0.02, shift=0.5)
    got = plain.rwkv6_time_in(x, ln, mu, prev)
    xn = L.rms_norm(x, ln)
    xp = _old_shift(xn, prev)
    want = [xn + (xp - xn) * mu.to(dtype)[i] for i in range(5)] + [xn[:, -1]]
    assert len(got) == 6
    for g, w in zip(got, want):
        assert g.dtype == dtype and torch.equal(g, w)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_channel_in_plain_is_the_models_expression(shape, carried, dtype):
    gen, x, ln, prev = _mix_inputs(shape, dtype, carried, seed=1)
    att = _randn(gen, *shape, dtype=dtype)
    mu = _randn(gen, 2, shape[2], dtype=dtype, scale=0.02, shift=0.5)
    got = plain.rwkv6_channel_in(x, att, ln, mu, prev)
    x2 = x + att
    xn = L.rms_norm(x2, ln)
    xp = _old_shift(xn, prev)
    mu = mu.to(dtype)
    want = [x2, xn + (xp - xn) * mu[0], xn + (xp - xn) * mu[1], xn[:, -1]]
    assert len(got) == 4
    for g, w in zip(got, want):
        assert g.dtype == dtype and torch.equal(g, w)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_decay_plain_is_the_models_expression(shape, dtype):
    b, t, hd = shape
    gen = torch.Generator().manual_seed(2)
    w0 = _randn(gen, hd, dtype=dtype, shift=-1.0)
    # wide enough that both clamp bounds bite
    lora = _randn(gen, b, t, hd, dtype=dtype, scale=4.0)
    logw = -torch.exp(torch.clamp((w0 + lora).float(), -8.0, 6.0))
    for out_dtype in (dtype, torch.float32):
        got = plain.rwkv6_decay(w0, lora, out_dtype)
        assert got.dtype == out_dtype
        assert torch.equal(got, logw.to(out_dtype))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_head_out_plain_is_the_models_expression(shape, dtype):
    b, t, hd = shape
    h, dh = hd // 64, 64
    gen = torch.Generator().manual_seed(3)
    out = _randn(gen, b, t, h, dh, dtype=dtype)
    ln_x = _randn(gen, h, dh, dtype=dtype, scale=0.1, shift=1.0)
    g_pre = _randn(gen, b, t, hd, dtype=dtype, scale=2.0)
    want = L.rms_norm(out, ln_x).reshape(b, t, hd) * F.silu(g_pre)
    got = plain.rwkv6_head_out(out, ln_x, g_pre)
    assert got.dtype == dtype and torch.equal(got, want)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_relu2_and_channel_out_plain_are_the_models_expressions(shape, dtype):
    gen = torch.Generator().manual_seed(4)
    hid = _randn(gen, *shape[:2], 3 * shape[2], dtype=dtype)
    assert torch.equal(plain.rwkv6_relu2(hid), torch.square(F.relu(hid)))
    x, r_pre, cv = (_randn(gen, *shape, dtype=dtype) for _ in range(3))
    assert torch.equal(plain.rwkv6_channel_out(x, r_pre, cv),
                       x + torch.sigmoid(r_pre) * cv)


# -- dispatch ---------------------------------------------------------------

def _op_args(dtype=torch.float32, grad=False, dh=16):
    """Small arguments of every glue op, by name (with ``dh`` not a multiple
    of 8, every row is off bfloat16's 16-byte vectors, relu2's too)."""
    gen = torch.Generator().manual_seed(5)
    b, t, h = 2, 3, 2
    d = h * dh

    def r(*shape, **kw):
        return _randn(gen, *shape, dtype=dtype, **kw).requires_grad_(grad)
    return {
        "rwkv6_time_in": (r(b, t, d), r(d), r(5, d), r(b, d)),
        "rwkv6_decay": (r(d), r(b, t, d), dtype),
        "rwkv6_head_out": (r(b, t, h, dh), r(h, dh), r(b, t, d)),
        "rwkv6_channel_in": (r(b, t, d), r(b, t, d), r(d), r(2, d), r(b, d)),
        "rwkv6_relu2": (r(b, t, 4 * d + dh % 8),),
        "rwkv6_channel_out": (r(b, t, d), r(b, t, d), r(b, t, d)),
    }


def test_glue_ops_are_kernels_with_launch_counts():
    names = [k.__name__ for k in GLUE]
    assert names == list(_op_args())
    assert all(k in KERNELS for k in GLUE)
    for k in GLUE:
        assert isinstance(k.launches, int)
        assert getattr(rwkv6_glue, k.__name__) is k
        assert getattr(plain, k.__name__) is getattr(rwkv6_glue,
                                                     k.__name__ + "_plain")


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
    before = getattr(rwkv6_glue, name).launches
    with pytest.raises(ValueError, match="runs on cuda tensors"):
        getattr(ops, name)(*_op_args()[name], implementation="cuda")
    with pytest.raises(ValueError, match="implementation must be one of"):
        getattr(ops, name)(*_op_args()[name], implementation="xla")
    assert getattr(rwkv6_glue, name).launches == before


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
    out = out if torch.is_tensor(out) else out[0]
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
    """The kernels move whole 16-byte vectors and have no other route: rows
    of 20 bfloat16 values, or operands one float32 past a 16-byte boundary,
    are refused by the wrapper before any launch."""
    if fault == "rows":
        args = _op_args(torch.bfloat16, dh=10)[name]
    else:
        args = tuple(_misaligned(a) for a in _op_args()[name])
    kern = getattr(rwkv6_glue, name)
    before = kern.launches
    with pytest.raises(ValueError, match="16-byte aligned"):
        kern(*args)
    assert kern.launches == before


# -- the model, before and after ---------------------------------------------

@pytest.fixture(scope="module", params=["bfloat16", "float32"])
def model(request):
    cfg = reduced(get_config("rwkv6-3b"), dtype=request.param)
    return cfg, rwkv6.init(cfg, seed=0, device="cpu")


def _tokens(cfg, b, s, seed):
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(0, cfg.vocab, (b, s), generator=gen)


def test_forward_unchanged_under_plain(model):
    cfg, params = model
    tokens = _tokens(cfg, 2, 40, 0)
    with torch.no_grad():
        got = rwkv6.forward(params, cfg, {"tokens": tokens}, impl=plain)
        want = _old_run(params, cfg, tokens)
    assert torch.equal(got, want)


@pytest.mark.parametrize("steps", [(13, 1, 1), (7, 9)])
def test_decode_and_slot_prefill_unchanged_under_plain(model, steps):
    """A prompt prefilled with state carried, then one-token steps (or a
    second chunk): the logits and every cache leaf, carries included."""
    cfg, params = model
    b = 2
    new = rwkv6.init_cache(cfg, b, 64, device="cpu")
    old = rwkv6.init_cache(cfg, b, 64, device="cpu")
    with torch.no_grad():
        for i, s in enumerate(steps):
            tokens = _tokens(cfg, b, s, 10 + i)
            got, new = rwkv6.decode_step(params, cfg, new, tokens, [0] * b,
                                         impl=plain)
            want = _old_run(params, cfg, tokens, cache=old)
            assert torch.equal(got, want)
            for g, w in zip(leaves(new), leaves(old)):
                assert torch.equal(g, w)
