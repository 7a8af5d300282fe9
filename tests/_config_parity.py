"""The rule by which the port's model config equals the reference's, shared
by the port's parity tests."""
import dataclasses


def same_config(cfg, jcfg):
    """The port's config is the reference's: each field the reference has
    is equal, and each field only the port has (zamba2's published form,
    ``hybrid_layer_ids`` and the rest) keeps its default."""
    mine, theirs = dataclasses.asdict(cfg), dataclasses.asdict(jcfg)
    assert {k: mine.get(k) for k in theirs} == theirs
    defaults = {f.name: f.default for f in dataclasses.fields(cfg)}
    assert {k: v for k, v in mine.items() if k not in theirs} == \
        {k: defaults[k] for k in mine if k not in theirs}
