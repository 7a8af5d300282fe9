"""The port's kernel layer against the reference's.

* The plain PyTorch versions (``repro_torch.kernels.ref``, reached through
  ``ops`` with ``implementation="torch"``) match ``repro.kernels.ops`` at
  ``implementation="interpret"`` (the Pallas kernels, interpreted) on the
  sweep shapes and dtypes of ``tests/test_kernels.py``, with its tolerances:
  float32 1e-5, bfloat16 5e-2 (atol x10), conv 1e-4 / 2e-3.
* Dispatch contracts: the (1, 1) float32 result of ``dot``, raising on a
  device/implementation mismatch, ``resolve_blocks``/``configure`` agreeing
  with the reference, and tuning-DB lookups that never read another
  backend's records.

The hand-written CUDA kernels are held against their plain versions on the
card by ``tests/test_torch_kernels_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as R_ops
from repro_torch.kernels import ops as T_ops
from repro_torch.kernels import ref as T_ref
from repro_torch.tuner.db import TuningDB, TuningRecord

RNG = np.random.default_rng(42)
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def pair(shape, dtype="float32"):
    """The same numpy draw as a jax array and a torch CPU tensor."""
    x = RNG.standard_normal(shape)
    jd, td = DTYPES[dtype]
    return jnp.asarray(x, jd), torch.as_tensor(x, dtype=td)


def close(got_t, want_j, rtol, atol):
    np.testing.assert_allclose(got_t.float().numpy(),
                               np.asarray(want_j, np.float32),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("m,n,k", [(32, 32, 32), (96, 72, 80), (17, 129, 65),
                                   (256, 64, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gemm_plain_matches_reference_kernel(m, n, k, dtype):
    (aj, at), (bj, bt) = pair((m, k), dtype), pair((k, n), dtype)
    want = R_ops.matmul(aj, bj, bm=32, bn=32, bk=32, implementation="interpret")
    got = T_ops.matmul(at, bt, implementation="torch")
    assert got.dtype == DTYPES[dtype][1] and got.shape == (m, n)
    tol = 1e-5 if dtype == "float32" else 5e-2
    close(got, want, tol, tol * 10)


@pytest.mark.parametrize("m,k", [(64, 64), (96, 80), (33, 257)])
def test_gemv_plain_matches_reference_kernel(m, k):
    (aj, at), (xj, xt) = pair((m, k)), pair((k,))
    got = T_ops.matvec(at, xt, implementation="torch")
    assert got.shape == (m,)
    close(got, R_ops.matvec(aj, xj, bm=32, bk=32, implementation="interpret"),
          1e-5, 1e-4)


@pytest.mark.parametrize("k", [64, 80, 1000])
def test_dot_plain_matches_reference_kernel(k):
    (aj, at), (bj, bt) = pair((k,)), pair((k,))
    close(T_ops.dot(at, bt, implementation="torch"),
          R_ops.dot(aj, bj, bk=64, implementation="interpret"), 1e-5, 1e-3)


@pytest.mark.parametrize("c,h,w,kk,r", [(8, 12, 14, 16, 3), (16, 18, 20, 24, 3),
                                        (4, 9, 9, 8, 1)])
def test_conv2d_plain_matches_reference_kernel(c, h, w, kk, r):
    (aj, at), (wj, wt) = pair((c, h, w)), pair((kk, c, r, r))
    got = T_ops.conv2d(at, wt, implementation="torch")
    assert got.shape == (kk, h - r + 1, w - r + 1)
    close(got, R_ops.conv2d(aj, wj, bk=8, implementation="interpret"),
          1e-4, 2e-3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dot_returns_1x1_float32(dtype):
    (aj, at), (bj, bt) = pair((300,), dtype), pair((300,), dtype)
    got = T_ops.dot(at, bt, implementation="torch")
    want = R_ops.dot(aj, bj, bk=64, implementation="interpret")
    assert got.shape == (1, 1) == want.shape
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    tol = 1e-5 if dtype == "float32" else 5e-2
    close(got, want, tol, tol * 10)


@pytest.mark.parametrize("op", ["matmul", "matvec", "dot", "conv2d"])
def test_ops_raise_on_device_or_implementation_mismatch(op):
    args = {"matmul": (torch.ones(4, 4), torch.ones(4, 4)),
            "matvec": (torch.ones(4, 4), torch.ones(4)),
            "dot": (torch.ones(4), torch.ones(4)),
            "conv2d": (torch.ones(2, 5, 5), torch.ones(3, 2, 3, 3))}[op]
    fn = getattr(T_ops, op)
    with pytest.raises(ValueError, match="cuda"):
        fn(*args, implementation="cuda")          # CPU tensors, card kernel
    with pytest.raises(ValueError, match="implementation"):
        fn(*args, implementation="interpret")     # the reference's backend
    assert fn(*args, implementation="torch").device.type == "cpu"


def test_kernel_wrappers_take_plain_path_only_for_cpu_tensors():
    from repro_torch.kernels import gemm
    a = torch.ones(3, 5)
    before = gemm.launches
    torch.testing.assert_close(gemm(a, a.T, bm=17, bn=96, bk=2048),
                               T_ref.gemm_ref(a, a.T))
    assert gemm.launches == before               # no kernel was launched
    with pytest.raises(ValueError):
        gemm(a, a.T, bm=0)                        # blocks must be positive


def test_bank_mm_takes_its_plain_version_on_the_cpu_and_checks_inputs():
    """The DQN bank's product on CPU tensors: its plain version (with the
    bias and ReLU), the bias and ReLU as ``baddbmm`` and ``relu`` give them,
    no launch; malformed operands raise."""
    from repro_torch.kernels import bank_mm
    from repro_torch.kernels.bank_mm import bank_mm_plain
    a = torch.as_tensor(RNG.standard_normal((3, 5, 4)), dtype=torch.float32)
    b = torch.as_tensor(RNG.standard_normal((3, 4, 6)), dtype=torch.float32)
    c = torch.as_tensor(RNG.standard_normal((3, 6)), dtype=torch.float32)
    before = bank_mm.launches
    assert torch.equal(bank_mm(a, b), torch.bmm(a, b))
    assert torch.equal(bank_mm(a, b, c, relu=True), bank_mm_plain(a, b, c,
                                                                  True))
    torch.testing.assert_close(bank_mm(a, b, c, relu=True),
                               torch.relu(a @ b + c[:, None]))
    assert bank_mm.launches == before             # no kernel was launched
    with pytest.raises(ValueError):
        bank_mm(a, b.transpose(1, 2))             # inner dims differ
    with pytest.raises(ValueError):
        bank_mm(a, b, c[:, :5])                   # bias of another width
    with pytest.raises(TypeError):
        bank_mm(a.double(), b.double())           # float32 only


@pytest.fixture
def clean_dispatch(tmp_path):
    # both dispatch layers start on an absent DB, whatever lies in the cwd
    for o in (R_ops, T_ops):
        o.reset_dispatch()
        o.set_tuning_db(tmp_path / "absent.json")
    yield tmp_path
    R_ops.reset_dispatch()
    T_ops.reset_dispatch()


def _db_with_records(path, backends):
    from repro.tuner.db import TuningDB as RDB
    from repro.tuner.db import TuningRecord as RRec
    blocks = {"interpret": {"bm": 16, "bn": 32, "bk": 64},
              "cuda": {"bm": 17, "bn": 96, "bk": 2048}}
    db = RDB(path)
    for be in backends:
        db.record(RRec("gemm", (64, 64, 64), "float32", be, blocks[be], 1e-3))
    db.set_app("tuned", {"hw": {"pe_rows": 40, "pe_cols": 200,
                                "pe_depth": 300}})
    db.save(path)
    return blocks


def test_resolve_blocks_and_configure_match_reference(clean_dispatch):
    path = clean_dispatch / "db.json"
    _db_with_records(path, ["interpret"])
    # defaults and explicit arguments, before any DB is configured
    for op, shape in (("gemm", (64, 64, 64)), ("gemv", (64, 32)),
                      ("dot", (128,)), ("conv2d", (8, 4, 6, 6, 3, 3))):
        assert T_ops.resolve_blocks(op, shape, torch.float32, "cuda",
                                    bk=7) == \
            R_ops.resolve_blocks(op, shape, jnp.float32, "pallas", bk=7)
    assert T_ops.configure("tuned", db_path=path) == \
        R_ops.configure("tuned", db_path=path)
    assert T_ops.configure("missing") == R_ops.configure("missing") == {}


def test_db_lookup_never_reads_interpret_records(clean_dispatch):
    path = clean_dispatch / "db.json"
    blocks = _db_with_records(path, ["interpret"])
    T_ops.set_tuning_db(path)
    R_ops.set_tuning_db(path)
    # the reference falls back onto its interpret measurements ...
    assert R_ops._db_best("gemm", (64, 64, 64), jnp.float32, "pallas") == \
        blocks["interpret"]
    # ... the port never does: another backend's record is no record
    assert T_ops._db_best("gemm", (64, 64, 64), torch.float32, "cuda") == {}
    assert T_ops.resolve_blocks("gemm", (64, 64, 64), torch.float32, "cuda",
                                bm=None) == T_ops.DEFAULT_BLOCKS["gemm"]
    # a record of the port's own backend is found
    _db_with_records(path, ["cuda"])
    assert T_ops._db_best("gemm", (64, 64, 64), torch.float32, "cuda") == \
        blocks["cuda"]
    assert TuningDB.load(path).best_config("gemm", (64, 64, 64)) == \
        blocks["cuda"]                     # the port's default backend


def test_port_db_has_its_own_default_path():
    from repro.tuner.db import DEFAULT_DB_PATH as REF_PATH
    from repro_torch.tuner.db import DEFAULT_DB_PATH
    assert DEFAULT_DB_PATH != REF_PATH
    assert TuningRecord("dot", (8,), "float32", "cuda", {"bk": 8}).key \
        == "dot|8|float32|cuda"
