"""Twin of tests/test_metrics_docs.py over the port:
`scripts/check_metrics_docs.py`'s scanners pointed at `paddle_tpu_torch/`
find every metric, label set and span name the port registers documented
in docs/OBSERVABILITY.md and every documented one registered — the port
in sync with the reference's docs (104 metrics, 56 non-empty label sets,
45 span names)."""
import importlib.util
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "paddle_tpu_torch")


@pytest.fixture(scope="module")
def mod():
    spec = importlib.util.spec_from_file_location(
        "check_metrics_docs",
        os.path.join(REPO, "scripts", "check_metrics_docs.py"))
    m = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(m)
    return m


def test_metrics_and_docs_in_sync(mod):
    code = mod.collect_code_metrics(PKG)
    docs = mod.collect_doc_metrics()
    assert sorted(set(code) - docs) == []
    assert sorted(docs - set(code)) == []
    assert len(code) == 104


def test_labels_and_docs_in_sync(mod):
    code = mod.collect_code_labels(PKG)
    docs = mod.collect_doc_labels()
    drift = {n: (code[n], docs[n]) for n in set(code) & set(docs)
             if code[n] != docs[n]}
    assert drift == {}
    assert len(set(code) & set(docs)) == 104
    assert sum(1 for v in code.values() if v) == 56
    assert code["serving_tenant_wire_bytes_total"] == {"tenant", "kind"}
    assert code["kv_pool_used_blocks"] == {"pool", "tier"}


def test_spans_and_docs_in_sync(mod):
    code = mod.collect_code_spans(PKG)
    docs = mod.collect_doc_spans()
    assert sorted(set(code) - docs) == []
    assert sorted(docs - set(code)) == []
    assert len(code) == 45
    for name in ("request_submitted", "prefill_chunk", "round",
                 "fleet_place", "migrate_out", "recover_requeue"):
        assert name in code, name
