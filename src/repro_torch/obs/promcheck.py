"""A copy of ``repro.obs.promcheck`` (stdlib only).

Prometheus text-exposition (0.0.4) conformance checker.

A deliberately strict, dependency-free parser for the output of
:meth:`repro_torch.obs.metrics.MetricsRegistry.prometheus_text`.  It exists so
"scrapes into any collector" is a *checked* claim, not an aspiration:
the obs tests run every registry exposition through it, the telemetry
endpoint's CI scrape is parsed with it, and any violation (unescaped
label value, HELP after TYPE, non-cumulative histogram buckets, a
``NaN``/``Inf`` literal where the artifact contract says ``null``)
fails loudly with a line number.

Checked rules (the subset of the exposition spec the registry can
violate):

* line grammar — every line is ``# HELP``, ``# TYPE``, blank, or a
  sample ``name{labels} value``; metric and label names match the
  spec's identifier grammar;
* ordering — ``HELP`` precedes ``TYPE`` precedes the samples of a
  family, each appears at most once, and a family's samples are
  contiguous (no interleaving with another family's);
* samples of an undeclared family (no ``TYPE``) are violations;
* label values use only the spec's escapes (``\\\\``, ``\\"``,
  ``\\n``) with no raw newline/quote, and no duplicate label names
  within one sample;
* values parse as floats and are finite — the registry's contract is
  "undefined is absent/null, never NaN/Inf";
* histograms — ``_bucket`` series carry an ``le`` label, bucket counts
  are cumulative (non-decreasing with ``le``), a ``+Inf`` bucket
  exists and equals ``_count``, and ``_count``/``_sum`` are present;
* counters never go negative.

Use :func:`check_exposition` for the error list, or
:func:`parse_exposition` for the parsed families when you also want
the samples.
"""
from __future__ import annotations

import math
import re

_METRIC_NAME = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_NAME = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")
# a spec-escaped label value: any char except raw `"`/`\`/newline, or an
# allowed escape sequence
_LABEL_VALUE = re.compile(r'^(?:[^"\\\n]|\\\\|\\"|\\n)*$')
_SAMPLE = re.compile(r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{.*\})?\s+(\S+)(?:\s+\d+)?$")
_TYPES = ("counter", "gauge", "histogram", "summary", "untyped")


def _parse_labels(raw: str, where: str, errs: list[str]) -> dict:
    """Parse ``{k="v",...}`` (escaped values), recording violations."""
    out: dict[str, str] = {}
    body = raw[1:-1]
    if not body:
        return out
    pos = 0
    pair = re.compile(r'\s*([a-zA-Z_][a-zA-Z0-9_]*)\s*=\s*"((?:[^"\\]|\\.)*)"\s*(,|$)')
    while pos < len(body):
        m = pair.match(body, pos)
        if not m:
            errs.append(f"{where}: malformed label block {raw!r}")
            return out
        name, value = m.group(1), m.group(2)
        if not _LABEL_VALUE.match(value):
            errs.append(f"{where}: label {name} value {value!r} uses an "
                        "escape outside \\\\, \\\", \\n")
        if name in out:
            errs.append(f"{where}: duplicate label {name!r}")
        out[name] = value
        pos = m.end()
    return out


def _family_of(sample_name: str) -> str:
    """The metric family a sample line belongs to (histogram series
    ``x_bucket``/``x_sum``/``x_count`` belong to family ``x``)."""
    for suffix in ("_bucket", "_sum", "_count"):
        if sample_name.endswith(suffix):
            return sample_name[: -len(suffix)]
    return sample_name


def parse_exposition(text: str) -> tuple[dict, list[str]]:
    """Parse exposition text into ``{family: {"type", "help", "samples"}}``
    plus the violation list (empty == conformant)."""
    errs: list[str] = []
    fams: dict[str, dict] = {}
    closed: set[str] = set()  # families whose sample run has ended
    current: str | None = None

    def fam(name: str) -> dict:
        return fams.setdefault(name, {"type": None, "help": None, "samples": []})

    for i, line in enumerate(text.splitlines(), start=1):
        where = f"line {i}"
        if not line.strip():
            continue
        if line.startswith("#"):
            m = re.match(r"^# (HELP|TYPE) ([a-zA-Z_:][a-zA-Z0-9_:]*)(?: (.*))?$", line)
            if not m:
                if line.startswith(("# HELP", "# TYPE")):
                    errs.append(f"{where}: malformed {line.split()[1]} line {line!r}")
                continue  # free-form comments are legal
            kind, name, rest = m.group(1), m.group(2), m.group(3) or ""
            f = fam(name)
            if kind == "HELP":
                if f["help"] is not None:
                    errs.append(f"{where}: duplicate HELP for {name}")
                if f["type"] is not None:
                    errs.append(f"{where}: HELP for {name} after its TYPE — "
                                "HELP must come first")
                if f["samples"]:
                    errs.append(f"{where}: HELP for {name} after its samples")
                f["help"] = rest
            else:
                if f["type"] is not None:
                    errs.append(f"{where}: duplicate TYPE for {name}")
                if f["samples"]:
                    errs.append(f"{where}: TYPE for {name} after its samples")
                if rest not in _TYPES:
                    errs.append(f"{where}: unknown TYPE {rest!r} for {name}")
                f["type"] = rest
            continue
        m = _SAMPLE.match(line)
        if not m:
            errs.append(f"{where}: unparseable sample line {line!r}")
            continue
        sname, raw_labels, raw_value = m.group(1), m.group(2), m.group(3)
        if not _METRIC_NAME.match(sname):
            errs.append(f"{where}: bad metric name {sname!r}")
        family = _family_of(sname)
        if family not in fams or fams[family]["type"] is None:
            # histogram series names only alias a family when it IS a
            # histogram; a plain metric named x_count is its own family
            if sname in fams and fams[sname]["type"] is not None:
                family = sname
            else:
                errs.append(f"{where}: sample {sname!r} has no TYPE declaration")
                family = sname
        if family != current:
            if family in closed:
                errs.append(f"{where}: samples of {family} interleave with "
                            "another family — a family's samples must be "
                            "contiguous")
            if current is not None:
                closed.add(current)
            current = family
        labels = _parse_labels(raw_labels, where, errs) if raw_labels else {}
        if raw_value.lower() in ("nan", "+nan", "-nan", "inf", "+inf", "-inf",
                                 "infinity", "+infinity", "-infinity"):
            errs.append(f"{where}: non-finite value {raw_value!r} — the "
                        "registry contract is null/absent, never NaN/Inf")
            value = math.nan
        else:
            try:
                value = float(raw_value)
            except ValueError:
                errs.append(f"{where}: unparseable value {raw_value!r}")
                continue
        fam(family)["samples"].append((sname, labels, value))
    return fams, errs


def _check_histogram(name: str, f: dict, errs: list[str]) -> None:
    buckets = [(ls, v) for sn, ls, v in f["samples"] if sn == f"{name}_bucket"]
    counts = [v for sn, _, v in f["samples"] if sn == f"{name}_count"]
    sums = [v for sn, _, v in f["samples"] if sn == f"{name}_sum"]
    if not buckets:
        errs.append(f"{name}: histogram with no _bucket samples")
        return
    if len(counts) != 1 or len(sums) != 1:
        errs.append(f"{name}: histogram needs exactly one _count and one _sum")
    les, vals = [], []
    for ls, v in buckets:
        le = ls.get("le")
        if le is None:
            errs.append(f"{name}: _bucket sample without an le label")
            return
        les.append(math.inf if le == "+Inf" else float(le))
        vals.append(v)
    order = sorted(range(len(les)), key=lambda i: les[i])
    last = -math.inf
    for i in order:
        if vals[i] < last:
            errs.append(
                f"{name}: bucket le={les[i]:g} count {vals[i]:g} below a "
                f"smaller bucket's {last:g} — buckets must be cumulative"
            )
        last = max(last, vals[i])
    if not math.isinf(les[order[-1]]):
        errs.append(f"{name}: histogram missing the +Inf bucket")
    elif counts and vals[order[-1]] != counts[0]:
        errs.append(
            f"{name}: +Inf bucket {vals[order[-1]]:g} != _count {counts[0]:g}"
        )


def check_exposition(text: str) -> list[str]:
    """All conformance violations in one exposition payload (empty list ==
    scrapes cleanly)."""
    fams, errs = parse_exposition(text)
    for name, f in fams.items():
        for sn, labels, v in f["samples"]:
            for ln in labels:
                if not _LABEL_NAME.match(ln):
                    errs.append(f"{name}: bad label name {ln!r}")
            if f["type"] == "counter" and not math.isnan(v) and v < 0:
                errs.append(f"{name}: negative counter sample {v:g}")
        if f["type"] == "histogram":
            _check_histogram(name, f, errs)
    return errs
