"""Port vs reference: plan lint.

The same plan document goes through both packages' ``lint_plan`` (or
``lint_plan_file``), and the findings must agree on (rule, severity, where)
in order: on the example plan and on one plan crafted for each rule.  The
one deliberate difference is pinned: the port knows the ``*_cuda`` kernel
mirrors and not the JAX package's ``*_pallas`` ones, so a hand-written plan
naming ``tubgemm_pallas`` is an ``unknown-design`` error here.  Grid
plans (``lint_grid_plan``: per-shard entries at their shard-local K, the
aggregate at the grid's K split) agree the same way.
"""

import json
import pathlib

import pytest

from repro.analysis import plan_lint as ref_lint
from repro.backends import grid as ref_grid
from repro.backends import plan as ref_plan
from repro_torch.analysis import plan_lint as port_lint
from repro_torch.backends import plan as port_plan

ROOT = pathlib.Path(__file__).resolve().parents[1]
FLAT = ROOT / "examples" / "plans" / "llama3_8b_smoke.plan.json"
GRID = ROOT / "examples" / "plans" / "llama3_8b_smoke.grid2x2.json"
SITES = ["layers/attn/wq", "layers/attn/wk", "layers/attn/wv",
         "layers/attn/wo", "layers/mlp/w_up", "layers/mlp/w_gate",
         "layers/mlp/w_down", "lm_head"]


def _doc(*entries, **meta):
    """A plan document from ``(pattern, design, bits[, extra fields])``."""
    return {"schema": port_plan.SCHEMA, "meta": meta,
            "sites": [{"pattern": p, "design": d, "bits": b, **dict(*extra)}
                      for p, d, b, *extra in entries]}


# rule -> (plan document, lint keyword arguments)
CASES = {
    "unknown-design": (_doc(("layers/*", "nope", 4)), {}),
    "invalid-bits": (_doc(("layers/*", "bgemm", 9), ("lm_head", "tubgemm", 1)),
                     {}),
    "shadowed-pattern-duplicate": (_doc(("layers/*", "bgemm", 4),
                                        ("layers/*", "tubgemm", 4)), {}),
    "shadowed-pattern-inventory": (_doc(("layers/attn/wq", "bgemm", 4),
                                        ("layers/attn/w?", "tubgemm", 4)),
                                   {"site_names": ["layers/attn/wq"]}),
    "dead-pattern": (_doc(("layers/*", "bgemm", 4), ("nothing/*", "bgemm", 4)),
                     {"site_names": SITES}),
    "unmatched-site": (_doc(("layers/attn/*", "tubgemm", 4)),
                       {"site_names": SITES}),
    "guard-relaxed": (_doc(("layers/*", "tubgemm", 2,
                            {"guard_relaxed": True, "rel_mse": 0.2})), {}),
    "acc-overflow": (_doc(("layers/mlp/w_down", "bgemm", 8, {"k": 1 << 20}),
                          ("layers/attn/wq", "tugemm", 8, {"k": 1 << 18})), {}),
    "invalid-stream": (_doc(("layers/*", "tubgemm", 4, {"stream_len": 16}),
                            ("lm_head", "ugemm_stochastic", 4)), {}),
    "stream-guard": (_doc(("layers/*", "ugemm_stochastic", 8,
                           {"stream_len": 1}), max_rel_mse=0.05), {}),
    "packed-width-mismatch": (_doc(("layers/*", "tubgemm", 4)),
                              {"packed_bits": {"layers/attn/wq": 8,
                                               "lm_head": 2}}),
    "clean": (_doc(("layers/*", "tubgemm", 4), ("lm_head", "bgemm", 8,
                                                 {"k": 4096})),
              {"site_names": SITES}),
}


def _keys(findings):
    return [(f.rule, f.severity, f.where) for f in findings]


def _both(doc, **kw):
    text = json.dumps(doc)
    ref = ref_lint.lint_plan(ref_plan.BackendPlan.from_json(text), **kw)
    port = port_lint.lint_plan(port_plan.BackendPlan.from_json(text), **kw)
    return _keys(ref), _keys(port)


@pytest.mark.parametrize("case", sorted(CASES))
def test_findings_equal(case):
    doc, kw = CASES[case]
    ref, port = _both(doc, **kw)
    assert port == ref
    rule = case.rsplit("-", 1)[0] if case.startswith("shadowed") else case
    if case == "clean":
        assert port == []
    else:
        assert rule in {r for r, _, _ in port}, port


def test_example_plan_findings_equal():
    text = FLAT.read_text()
    for kw in ({}, {"site_names": SITES}):
        ref = ref_lint.lint_plan(ref_plan.BackendPlan.from_json(text), **kw)
        port = port_lint.lint_plan(port_plan.BackendPlan.from_json(text), **kw)
        assert _keys(port) == _keys(ref) == []
    assert _keys(port_lint.lint_plan_file(FLAT, site_names=SITES)) == \
        _keys(ref_lint.lint_plan_file(FLAT, site_names=SITES)) == []


def test_unloadable_plan_file(tmp_path):
    bad = tmp_path / "bad.json"
    bad.write_text('{"schema": "something/else", "sites": []}')
    assert _keys(port_lint.lint_plan_file(bad)) == \
        _keys(ref_lint.lint_plan_file(bad))
    assert [f.rule for f in port_lint.lint_plan_file(bad)] == ["unloadable-plan"]


def test_mirror_names_are_the_deliberate_difference():
    """``tubgemm_pallas`` names no kernel on this card (its counterpart is
    ``tubgemm_cuda``): unknown to the port, known to the reference; the
    ``_cuda`` name the other way round."""
    for design, ref_known in (("tubgemm_pallas", True), ("tubgemm_cuda", False)):
        ref, port = _both(_doc(("layers/*", design, 4)))
        where = f"sites[0] 'layers/*' -> {design}@4b"
        assert (port == [("unknown-design", "error", where)]) == ref_known
        assert (ref == [("unknown-design", "error", where)]) != ref_known


def test_grid_plans_raise():
    # grid plans lint in both packages with the same findings: the example
    # file, and the same document parsed by each package's GridPlan
    from repro_torch.backends import grid as port_grid
    assert _keys(port_lint.lint_plan_file(GRID)) == \
        _keys(ref_lint.lint_plan_file(GRID))
    text = GRID.read_text()
    assert _keys(port_lint.lint_plan(port_grid.GridPlan.from_json(text),
                                     site_names=SITES)) == \
        _keys(ref_lint.lint_plan(ref_grid.GridPlan.from_json(text),
                                 site_names=SITES))
    with pytest.raises(TypeError):
        port_lint.lint_plan({"schema": port_plan.SCHEMA})
