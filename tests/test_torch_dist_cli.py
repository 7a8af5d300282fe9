"""The port's CLIs on a process group of two ranks (``gloo`` on the CPU,
a ``FileStore`` rendezvous, as ``torchrun`` would launch them), each test
with its own timeout.

* ``launch.serve --mesh data=1,model=2``: rank 0 prints the mesh and the
  requests, token for token what one process with the same tp=2 params
  serves (float32); rank 1 prints nothing.
* ``launch.train`` on the host mesh (data-parallel, ZeRO-1): crashed by
  ``--inject-failure-at`` and rerun, it resumes from its checkpoint
  (with ``--grad-compression``: the residual rides along); the
  checkpoint, whole arrays, restores in one process (an elastic re-mesh
  through the CLI).
"""
import re
from pathlib import Path

from repro_torch.launch.mesh import run_ranks

SRC = str(Path(__file__).resolve().parents[1] / "src")
ONE_THREAD = {"OMP_NUM_THREADS": "1", "PYTHONPATH": SRC}


def _reqs(out: str) -> list[str]:
    return re.findall(r"^req \d+: .*$", out, flags=re.M)


def test_serve_cli_on_two_ranks_matches_one_process(tmp_path):
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import family_module, reduced

    args = ["-m", "repro_torch.launch.serve", "--smoke", "--device", "cpu",
            "--arch", "qwen3-8b", "--requests", "3", "--max-new", "4",
            "--paged", "--page-size", "4", "--mesh", "data=1,model=2"]
    procs = run_ranks(args, 2, tmp_path, timeout=100, env=ONE_THREAD)
    for p in procs:
        assert p.returncode == 0, p.stderr[-3000:]
    assert "mesh: data=1xmodel=2" in procs[0].stdout
    assert procs[1].stdout.strip() == ""
    got = _reqs(procs[0].stdout)
    assert len(got) == 3
    # the same requests in one process on the same (tp=2) params: the
    # smoke config is bfloat16, so hold the prompts and the first tokens
    cfg = reduced(get_config("qwen3-8b"))
    params = family_module(cfg).init(cfg, seed=0, tp=2, device="cpu")
    reqs = serve.make_requests(cfg, 3, 4, 0)
    done, _ = serve.serve_requests(cfg, params, reqs, tp=2, impl="torch",
                                   paged=True, page_size=4)
    for line, req in zip(got, done):
        head = f"req {req.rid}: prompt[{len(req.prompt)}] -> " \
               f"[{req.out[0]},"
        assert line.startswith(head), (line, req.out)


def test_train_cli_on_two_ranks_resumes_and_restores_in_one(tmp_path):
    from repro_torch.launch import train

    ck = str(tmp_path / "ck")
    base = ["-m", "repro_torch.launch.train", "--smoke", "--device", "cpu",
            "--arch", "qwen3-8b", "--steps", "6", "--checkpoint-every", "2",
            "--global-batch", "4", "--seq-len", "16", "--checkpoint-dir",
            ck, "--grad-compression"]
    crashed = run_ranks(base + ["--inject-failure-at", "3"], 2,
                        tmp_path / "a", timeout=55, env=ONE_THREAD)
    for p in crashed:
        assert p.returncode != 0
        assert "injected failure at step 3" in p.stderr
    resumed = run_ranks(base, 2, tmp_path / "b", timeout=55,
                        env=ONE_THREAD)
    for p in resumed:
        assert p.returncode == 0, p.stderr[-3000:]
    assert "resumed from checkpoint step 2" in resumed[0].stdout
    assert "step    5" in resumed[0].stdout
    assert resumed[1].stdout.strip() == ""
    # the files hold whole arrays: one process restores them
    train.main(base[2:] + ["--steps", "8"])
