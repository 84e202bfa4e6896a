"""/metrics federation over per-replica exporters: the port's copy of
`paddle_tpu.fleet.federation`.

Each replica runs the ops plane and exposes its own Prometheus
text at /metrics; the fleet front door serves ONE merged page where
every per-replica sample carries a `replica="<name>"` label — the
standard federation shape, so one scrape of the router sees the whole
fleet. `# HELP` / `# TYPE` comment lines are deduplicated (first
source wins); fleet-level series (`fleet_*`, already labeled where it
matters) are appended once, unrelabeled.

The rewriting is textual on the exposition format — it works over any
source (an in-process registry snapshot or an HTTP fetch from a
subprocess replica) without importing its registry.
"""
from __future__ import annotations

import urllib.request

_ESC = {"\\": "\\\\", '"': '\\"', "\n": "\\n"}


def _escape(value):
    return "".join(_ESC.get(c, c) for c in str(value))


def add_label_to_prom_text(text, label, value):
    """Inject `label="value"` into every SAMPLE line of a Prometheus
    text page (comments and blank lines pass through untouched).
    Handles both bare (`name 1.0`) and labeled
    (`name{a="b"} 1.0`) samples, including histogram `_bucket`
    series."""
    lv = f'{label}="{_escape(value)}"'
    out = []
    for line in text.splitlines():
        s = line.strip()
        if not s or s.startswith("#"):
            out.append(line)
            continue
        brace = line.find("{")
        space = line.find(" ")
        if brace != -1 and (space == -1 or brace < space):
            out.append(line[:brace + 1] + lv + ","
                       + line[brace + 1:])
        elif space != -1:
            out.append(line[:space] + "{" + lv + "}" + line[space:])
        else:  # not a sample line; pass through
            out.append(line)
    return "\n".join(out)


def federate_metrics(sources, extra=""):
    """Merge per-replica Prometheus pages into one federated page.

    sources: iterable of (replica_name, text_or_fetcher) — a str of
        Prometheus text, or a zero-arg callable returning one (an
        unreachable source contributes a comment line instead of
        failing the whole page).
    extra: fleet-level text appended verbatim at the end (the
        router's own `fleet_*` series).
    """
    out = []
    seen_comments = set()
    for name, src in sources:
        try:
            text = src() if callable(src) else str(src)
        except Exception as e:  # noqa: BLE001 — one dead replica must
            # not take down the whole federated page
            out.append(f"# replica {name}: unreachable "
                       f"({type(e).__name__}: {e})")
            continue
        labeled = add_label_to_prom_text(text, "replica", name)
        for line in labeled.splitlines():
            if line.startswith("#"):
                if line in seen_comments:
                    continue
                seen_comments.add(line)
            out.append(line)
    if extra:
        for line in str(extra).splitlines():
            if line.startswith("#") and line in seen_comments:
                continue
            out.append(line)
    return "\n".join(out) + "\n"


def http_fetcher(url, timeout=2.0):
    """A zero-arg /metrics fetcher for a subprocess/remote replica's
    exporter URL (the in-process default reads the registry
    directly)."""
    def fetch():
        with urllib.request.urlopen(f"{url}/metrics",
                                    timeout=timeout) as r:
            return r.read().decode("utf-8")
    return fetch
