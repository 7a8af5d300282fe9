"""The port's hot-path auditor (``repro_torch.analysis.trace_audit``), held
to its own rule catalog (the reference's ``jaxpr_audit`` catalog mapped
rule for rule; ``tests/test_analysis_audit.py::test_host_callback_detected``
fails on this stack, so the reference's detector is not the yardstick):

  * every reference rule has its port counterpart;
  * each port rule fires on a minimal seeded program, and a clean program
    has no findings (as ``tests/test_analysis_audit.py:49-130``);
  * ``trace/host-sync`` follows device data: ``.item()`` on a tensor
    computed from an argument fires, the same on a host tensor built
    inside the program does not, and a non-blocking upload is clean;
  * ``audit_hot_paths`` on reduced qwen3-8b, granite-moe-3b-a800m,
    zamba2-2.7b and hubert-xlarge finds exactly the findings pinned here:
    the train step's host syncs (the embedding backward's sort-based
    segment sum, AdamW's constant learning rate uploaded each step) and
    its captured learning rate, the dense decode's graph breaks and the
    slot write's python slot index.  The serving programs sync nowhere.
"""
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.analysis import trace_audit as ta
from repro_torch.configs import get_config
from repro_torch.models import reduced

SRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch"


def _rules(findings):
    return {f.rule for f in findings}


def test_every_reference_rule_has_a_counterpart():
    import repro.analysis.jaxpr_audit  # noqa: F401  (registers its rules)
    from repro.analysis.findings import RULES as REF_RULES

    ref = {r for r in REF_RULES if r.startswith("jaxpr/")}
    assert set(ta.REFERENCE_RULES) == ref
    assert all(r.startswith("trace/") for r in ta.REFERENCE_RULES.values())
    assert len(set(ta.REFERENCE_RULES.values())) == len(ref)


# ---------------------------------------------------------------------------
# seeded programs, one per rule
# ---------------------------------------------------------------------------

STATE = {"n": 1}
SCALAR = torch.tensor(2.0)
TABLE = torch.ones(1024, 512)          # 2 MiB


def _item(x):
    return x * x.sum().item()


def _host_item(x):
    h = torch.arange(3)                 # built on the host inside
    return x * int(h.sum().item())


def _cpu(x):
    return x + float(x.cpu().numpy()[0])


def _mask(x):
    return x[x > 0]


def _nonzero(x):
    return x.nonzero()


def _unique(x):
    return torch.unique_consecutive(x)


def _blocking_upload(x):
    return x + torch.as_tensor(np.ones(4, np.float32), device=x.device)


def _blocking_to(x):
    return x + torch.ones(4).to(x.device)


def _nonblocking_to(x):
    return x + torch.ones(4).to(x.device, non_blocking=True)


def _host_index(x):
    return x[torch.tensor([0, 2])]


HOST_SYNC = {"item": (_item, True), "host-item": (_host_item, False),
             "cpu": (_cpu, True), "bool-mask": (_mask, True),
             "nonzero": (_nonzero, True), "unique": (_unique, True),
             "blocking-upload": (_blocking_upload, True),
             "blocking-to": (_blocking_to, True),
             "nonblocking-to": (_nonblocking_to, False),
             "host-index": (_host_index, True)}


@pytest.mark.parametrize("case", sorted(HOST_SYNC))
def test_host_sync_follows_device_data(case):
    fn, fires = HOST_SYNC[case]
    got = ta.audit_program(fn, torch.arange(4.0), site="t")
    syncs = [f for f in got if f.rule == ta.R_HOST_SYNC]
    assert bool(syncs) == fires, [str(f) for f in got]
    if fires:
        assert {f.severity for f in syncs} == {"error"}
        line = fn.__code__.co_firstlineno + 1
        assert ta.sync_sources(syncs) == {f"test_torch_audit.py:{line}"}


def test_clean_program_has_no_findings():
    def f(x, y):
        return x @ y + 1

    a, b = torch.ones(4, 4), torch.ones(4, 4)
    assert ta.audit_program(f, a, b, site="t") == []
    assert ta.audit_retrace(f, (a, b), (a + 1, b), site="t") == []
    assert ta.audit_recompile(f, [(a, b), (a + 1, b), (a + 2, b)],
                              site="t") == []


def test_state_dependent_trace_detected():
    def f(x):
        return x * STATE["n"]

    x = torch.ones(4)
    STATE["n"] = 1
    a = ta._graph(f, (x,), "t").code
    STATE["n"] = 2
    b = ta._graph(f, (x,), "t").code
    assert a != b

    class Tick:                         # the state moves between traces
        def __init__(self):
            self.n = 0

        def __call__(self, x):
            self.n += 1
            return x * self.n

    got = ta.audit_retrace(Tick(), (x,), (x,), site="t")
    assert _rules(got) == {ta.R_STATE_TRACE}
    assert got[0].severity == "error"


def test_silent_recompile_detected():
    def f(x):
        return x * STATE["n"]

    def tick(n):
        STATE["n"] = n
        return (torch.ones(4),)

    class Ticks:                        # each tick moves the global first
        def __iter__(self):
            for n in (1, 2, 3):
                yield tick(n)

    got = ta.audit_recompile(f, Ticks(), site="t")
    assert ta.R_RECOMPILE in _rules(got)


def test_graph_break_reported_as_info():
    def f(x):
        y = x * 2
        torch._dynamo.graph_break()
        return y + 1

    x = torch.ones(4)
    got = ta.audit_recompile(f, [(x,), (x + 1,), (x + 2,)], site="t")
    assert _rules(got) == {ta.R_GRAPH_BREAK}
    assert got[0].severity == "info"


def test_python_scalar_arg_flagged():
    def f(x, n):
        return x * n

    got = ta.audit_program(f, torch.ones(4), 3, site="t")
    assert _rules(got) == {ta.R_SCALAR_ARG}
    assert got[0].severity == "warning"
    assert ta.audit_program(f, torch.ones(4), torch.tensor(3),
                            site="t") == []


def test_scalar_closure_capture_detected():
    def f(x):
        return x * SCALAR

    got = ta.audit_program(f, torch.ones(4), site="t")
    assert _rules(got) == {ta.R_SCALAR_CONST}
    assert got[0].severity == "error"


def test_large_const_capture_flagged():
    def f(x):
        return x @ TABLE

    got = ta.audit_program(f, torch.ones(4, 1024), site="t")
    assert _rules(got) == {ta.R_BIG_CONST}
    assert got[0].severity == "warning"


def test_out_of_place_update_flagged_and_silenced_in_place():
    big = torch.ones(256, 128)          # 128 KiB

    got = ta.audit_program(lambda t: t * 2, big.clone(), site="t")
    assert _rules(got) == {ta.R_OUT_OF_PLACE}
    assert ta.audit_program(lambda t: t.mul_(2), big.clone(),
                            site="t") == []
    small = torch.ones(8, 8)
    assert ta.audit_program(lambda t: t * 2, small, site="t") == []


def test_no_introspection_without_dynamo(monkeypatch):
    monkeypatch.setattr(ta, "_dynamo", lambda: None)
    got = ta.audit_recompile(lambda x: x, [(torch.ones(2),)], site="t")
    assert _rules(got) == {ta.R_NO_INTROSPECTION}
    assert got[0].severity == "info"


def test_untraceable_program_reported_as_info(monkeypatch):
    from torch.fx.experimental import proxy_tensor

    def refuse(fn, **kw):
        def trace(*args):
            raise RuntimeError("cannot trace this program")
        return trace

    # where make_fx refuses a program the retrace check reports it
    monkeypatch.setattr(proxy_tensor, "make_fx", refuse)
    x = torch.ones(4)
    got = ta.audit_retrace(lambda t: t * 2, (x,), (x,), site="t")
    assert _rules(got) == {ta.R_NO_GRAPH}
    assert got[0].severity == "info"


# ---------------------------------------------------------------------------
# the shipped hot paths, pinned
# ---------------------------------------------------------------------------

def _line(rel: str, snippet: str) -> str:
    """``file:line`` of the one line of ``src/repro_torch/<rel>`` holding
    ``snippet``."""
    lines = (SRC / rel).read_text().splitlines()
    hits = [i + 1 for i, ln in enumerate(lines) if snippet in ln]
    assert len(hits) == 1, (rel, snippet, hits)
    return f"repro_torch/{rel}:{hits[0]}"


def _train_step_findings(name: str, embeds: bool) -> set:
    site = f"{name}/train_step"
    got = {("error", ta.R_HOST_SYNC, site,
            _line("optim/adamw.py", "lambda step: torch.tensor(lr")),
           ("error", ta.R_SCALAR_CONST, site, None)}
    if embeds:       # the embedding's backward: a sort-based segment sum
        got |= {("error", ta.R_HOST_SYNC, site, _line("models/layers.py", s))
                for s in ("torch.unique_consecutive(ids_sorted",
                          "run = torch.repeat_interleave(",
                          "longest = int(counts.max())",
                          "recv = torch.nonzero(")}
    return got


def _pinned(name: str, encoder: bool) -> set:
    got = _train_step_findings(name, embeds=not encoder)
    if not encoder:
        got |= {("info", ta.R_GRAPH_BREAK, f"{name}/serve_decode", None),
                ("warning", ta.R_SCALAR_ARG, f"{name}/serve_write_slot",
                 None)}
    return got


def _found(findings) -> set:
    out = set()
    for f in findings:
        src = ta.sync_sources([f])
        out.add((f.severity, f.rule, f.site, src.pop() if src else None))
    return out


@pytest.mark.parametrize("arch", ["qwen3-8b", "granite-moe-3b-a800m",
                                  "zamba2-2.7b", "hubert-xlarge"])
def test_hot_paths_pinned(arch):
    cfg = reduced(get_config(arch))
    got = ta.audit_hot_paths(cfg, device="cpu")
    assert _found(got) == _pinned(cfg.name, encoder=cfg.embed_inputs), \
        [str(f) for f in got]
    assert len(got) == len(_found(got))


# ---------------------------------------------------------------------------
# the card: the syncs it reports join the audit
# ---------------------------------------------------------------------------

def test_card_findings_add_only_unexplained_syncs(monkeypatch):
    def program(t):
        return t.sum().item()

    x = torch.arange(4.0)
    watched = ta.audit_program(program, x, site="t")
    (known,) = ta.sync_sources(watched)
    reported = [known, "elsewhere.py:7", "elsewhere.py:7"]
    monkeypatch.setattr(ta, "reported_syncs",
                        lambda fn, *args: (fn(*args), reported))
    got = ta.card_findings(program, x, findings=watched, site="t")
    assert [(f.severity, f.rule, f.site) for f in got] == \
        [("error", ta.R_HOST_SYNC, "t")]
    assert ta.sync_sources(got) == {"elsewhere.py:7"}
    assert "reported by the card" in got[0].detail and "(2x)" in \
        got[0].detail


def test_audit_runs_on_the_card_unless_asked_for_the_cpu(monkeypatch,
                                                         tmp_path, capsys):
    from repro_torch.analysis.__main__ import main

    cfg = reduced(get_config("hubert-xlarge"))
    argv = ["--no-golden", "--arch", "hubert-xlarge", "--mesh", "none",
            "--audit", "hubert-xlarge", "--json", str(tmp_path / "f.json")]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ta.audit_hot_paths(cfg)
    with pytest.raises(SystemExit, match="--device cpu"):
        main(argv)
    # on the CPU: the train step's syncs (ROADMAP C.3) make it exit 1
    assert main(argv + ["--device", "cpu"]) == 1
    out = capsys.readouterr().out
    assert "audit hubert-xlarge: 2 error" in out, out
    assert not any(f.severity == "error" and "reported by the card"
                   in f.detail for f in ta.audit_hot_paths(cfg,
                                                           device="cpu"))


@pytest.mark.cuda
def test_card_reports_a_real_sync_the_watch_names():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the card reports the syncs")

    def program(t):
        return t.sum().item()

    x = torch.arange(4.0, device="cuda")
    _, got = ta.reported_syncs(program, x)
    line = f"test_torch_audit.py:{program.__code__.co_firstlineno + 1}"
    assert got == [line]
    watched = ta.audit_program(program, x, site="t")
    assert ta.sync_sources(watched) == {line}
    assert ta.card_findings(program, x, findings=watched, site="t") == []
    _, got = ta.reported_syncs(lambda t: t * 2, x)
    assert got == []
