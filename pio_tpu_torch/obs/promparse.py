"""Small Prometheus text-format parser (and re-renderer).

The port's copy of ``pio_tpu/obs/promparse.py`` (the port imports nothing of
``pio_tpu``).

Shared by the test suite (round-tripping every ``/metrics`` endpoint),
``bench.py`` (server-side metric deltas embedded in the bench artifact),
the dashboard's serving view, and the fleet aggregator, which
parses every member's scrape, relabels it with ``pio_tpu_member``, merges
and re-exposes the union. Parses the subset the exposition spec defines
for text format 0.0.4: ``# HELP``/``# TYPE`` comment lines and
``name{labels} value`` samples with escaped label values, plus the
OpenMetrics-style exemplar suffix our histograms append to bucket lines
(``... 42 # {trace_id="query-7"} 0.0042``).

Federation helpers:

- ``merge(*scrapes)`` — counters (and histogram series) sum, gauges are
  last-write-wins, conflicting ``# TYPE`` declarations raise;
- ``with_labels(pm, member=...)`` — inject a label into every sample;
- ``render(pm)`` — back to exposition text, round-trip-stable through
  ``parse_prometheus_text`` (exemplars included).
"""

from __future__ import annotations

from typing import Dict, FrozenSet, List, Optional, Tuple

LabelSet = FrozenSet[Tuple[str, str]]

#: suffixes that belong to a histogram/summary family rather than being
#: metric names of their own
_FAMILY_SUFFIXES = ("_bucket", "_sum", "_count")


class ParsedMetrics:
    """Samples keyed by (metric name, frozenset of label pairs)."""

    def __init__(self):
        self.samples: Dict[Tuple[str, LabelSet], float] = {}
        self.types: Dict[str, str] = {}
        self.helps: Dict[str, str] = {}
        #: exemplars keyed like samples: (exemplar labels, exemplar value)
        self.exemplars: Dict[
            Tuple[str, LabelSet], Tuple[LabelSet, Optional[float]]
        ] = {}

    def value(self, name: str, **labels) -> Optional[float]:
        return self.samples.get((name, frozenset(
            (k, str(v)) for k, v in labels.items()
        )))

    def exemplar(self, name: str, **labels
                 ) -> Optional[Tuple[Dict[str, str], Optional[float]]]:
        """The exemplar attached to one sample line (bucket lines carry
        them), as ``({label: value}, observed_value)`` — e.g.
        ``({"trace_id": "query-7"}, 0.0042)``."""
        got = self.exemplars.get((name, frozenset(
            (k, str(v)) for k, v in labels.items()
        )))
        if got is None:
            return None
        ls, v = got
        return dict(ls), v

    def family(self, name: str) -> Dict[LabelSet, float]:
        """Every sample of one metric name, keyed by label set."""
        return {
            ls: v for (n, ls), v in self.samples.items() if n == name
        }

    def histogram_buckets(self, name: str, **labels):
        """Sorted ``[(le_float, cumulative_count)]`` for one histogram
        cell (``le`` excluded from the matching labels)."""
        want = {(k, str(v)) for k, v in labels.items()}
        out = []
        for ls, v in self.family(name + "_bucket").items():
            d = dict(ls)
            le = d.pop("le", None)
            if le is None or set(d.items()) != want:
                continue
            out.append((float("inf") if le == "+Inf" else float(le), v))
        out.sort(key=lambda p: p[0])
        return out

    def histogram_quantile(self, name: str, q: float,
                           **labels) -> Optional[float]:
        """Bucket-interpolated quantile from an exposed histogram (the
        PromQL ``histogram_quantile`` estimate)."""
        buckets = self.histogram_buckets(name, **labels)
        if not buckets or buckets[-1][1] <= 0:
            return None
        total = buckets[-1][1]
        rank = q * total
        prev_le, prev_cum = 0.0, 0.0
        for le, cum in buckets:
            if cum >= rank:
                if le == float("inf"):
                    return prev_le
                c = cum - prev_cum
                frac = (rank - prev_cum) / c if c > 0 else 1.0
                return prev_le + (le - prev_le) * min(max(frac, 0.0), 1.0)
            prev_le, prev_cum = le, cum
        return prev_le


def _unescape(s: str) -> str:
    out = []
    i = 0
    while i < len(s):
        c = s[i]
        if c == "\\" and i + 1 < len(s):
            nxt = s[i + 1]
            out.append({"\\": "\\", '"': '"', "n": "\n"}.get(nxt, nxt))
            i += 2
        else:
            out.append(c)
            i += 1
    return "".join(out)


def _parse_labels(s: str) -> LabelSet:
    """``a="b",c="d"`` (already stripped of braces) → label set."""
    pairs = []
    i = 0
    while i < len(s):
        eq = s.index("=", i)
        name = s[i:eq].strip().lstrip(",").strip()
        assert s[eq + 1] == '"', f"unquoted label value near {s[i:]!r}"
        j = eq + 2
        buf = []
        while s[j] != '"':
            if s[j] == "\\":
                buf.append(s[j:j + 2])
                j += 2
            else:
                buf.append(s[j])
                j += 1
        pairs.append((name, _unescape("".join(buf))))
        i = j + 1
    return frozenset(pairs)


def parse_prometheus_text(text: str) -> ParsedMetrics:
    out = ParsedMetrics()
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) >= 4 and parts[1] == "HELP":
                out.helps[parts[2]] = _unescape(parts[3])
            elif len(parts) >= 4 and parts[1] == "TYPE":
                out.types[parts[2]] = parts[3]
            continue
        # sample: name[{labels}] value [timestamp] [# {exemplar} value]
        exemplar = None
        if " # " in line:
            base, ex_str = line.split(" # ", 1)
            if ex_str.startswith("{") and "}" in ex_str:
                line = base.rstrip()
                ex_labels_str, ex_rest = ex_str[1:].split("}", 1)
                ex_parts = ex_rest.split()
                exemplar = (
                    _parse_labels(ex_labels_str),
                    float(ex_parts[0]) if ex_parts else None,
                )
        if "{" in line:
            name, rest = line.split("{", 1)
            labels_str, rest = rest.rsplit("}", 1)
            labels = _parse_labels(labels_str)
        else:
            name, rest = line.split(None, 1)
            labels = frozenset()
        value_str = rest.split()[0]
        value = (
            float("inf") if value_str == "+Inf"
            else float("-inf") if value_str == "-Inf"
            else float(value_str)
        )
        out.samples[(name.strip(), labels)] = value
        if exemplar is not None:
            out.exemplars[(name.strip(), labels)] = exemplar
    return out


# ---------------------------------------------------------------------------
# federation helpers
# ---------------------------------------------------------------------------

def family_base(name: str, types: Dict[str, str]) -> str:
    """The family a sample line belongs to: ``foo_bucket``/``foo_sum``/
    ``foo_count`` collapse to ``foo`` when ``foo`` is a declared
    histogram or summary; every other name is its own family."""
    for suf in _FAMILY_SUFFIXES:
        if name.endswith(suf):
            base = name[: -len(suf)]
            if types.get(base) in ("histogram", "summary"):
                return base
    return name


def _merge_mode(name: str, types: Dict[str, str]) -> str:
    """``sum`` or ``last`` for one sample name under the merged types."""
    base = family_base(name, types)
    typ = types.get(base)
    if typ == "counter":
        return "sum"
    if typ in ("histogram", "summary"):
        # bucket/sum/count series are cumulative -> add; summary
        # quantile samples are point estimates -> last-write-wins
        if name != base or typ == "histogram":
            return "sum"
        return "last"
    if typ == "gauge":
        return "last"
    # untyped: counter naming discipline says *_total is cumulative
    return "sum" if name.endswith("_total") else "last"


def merge(*scrapes: ParsedMetrics) -> ParsedMetrics:
    """Merge scrapes into one: counter(-like) series sum, gauges are
    last-write-wins (later argument wins), histograms add bucket-wise
    (their ``_bucket``/``_sum``/``_count`` series are all cumulative).
    Exemplars are last-write-wins per sample. A family declared with
    two different ``# TYPE``\\ s across scrapes raises ``ValueError`` —
    silently summing a gauge into a counter would corrupt both."""
    out = ParsedMetrics()
    for pm in scrapes:
        for fam, typ in pm.types.items():
            prev = out.types.get(fam)
            if prev is not None and prev != typ:
                raise ValueError(
                    f"conflicting TYPE for {fam!r}: {prev!r} vs {typ!r}"
                )
            out.types[fam] = typ
        for fam, h in pm.helps.items():
            out.helps.setdefault(fam, h)
    for pm in scrapes:
        for key, v in pm.samples.items():
            if _merge_mode(key[0], out.types) == "sum":
                out.samples[key] = out.samples.get(key, 0.0) + v
            else:
                out.samples[key] = v
        out.exemplars.update(pm.exemplars)
    return out


def with_labels(pm: ParsedMetrics, **labels) -> ParsedMetrics:
    """A copy of ``pm`` with ``labels`` injected into every sample (the
    fleet aggregator stamps ``pio_tpu_member="host:port"`` this way).
    An injected name overrides any same-named label already present."""
    inj = tuple((k, str(v)) for k, v in labels.items())
    names = frozenset(k for k, _ in inj)

    def rekey(key):
        name, ls = key
        kept = tuple(p for p in ls if p[0] not in names)
        return name, frozenset(kept + inj)

    out = ParsedMetrics()
    out.types.update(pm.types)
    out.helps.update(pm.helps)
    out.samples = {rekey(k): v for k, v in pm.samples.items()}
    out.exemplars = {rekey(k): v for k, v in pm.exemplars.items()}
    return out


def _esc_label(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt_value(v: float) -> str:
    if v == float("inf"):
        return "+Inf"
    if v == float("-inf"):
        return "-Inf"
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(v)


def _sample_sort_key(name: str, ls: LabelSet):
    """Stable order: name, then labels (with ``le`` compared numerically
    last so histogram buckets render in ascending edge order)."""
    d = dict(ls)
    le = d.pop("le", None)
    le_v = (
        0.0 if le is None
        else float("inf") if le == "+Inf" else float(le)
    )
    return name, tuple(sorted(d.items())), le_v


def render(pm: ParsedMetrics) -> List[str]:
    """Exposition lines for ``pm`` — HELP/TYPE once per family, samples
    grouped under their family, exemplars re-attached. The output parses
    back to an equal ``ParsedMetrics`` (the round-trip property the unit
    tests pin down)."""
    fams: Dict[str, List[Tuple[str, LabelSet]]] = {}
    for (name, ls) in pm.samples:
        fams.setdefault(family_base(name, pm.types), []).append((name, ls))
    # families with only HELP/TYPE and no samples still render their head
    for fam in list(pm.types) + list(pm.helps):
        fams.setdefault(fam, [])
    lines: List[str] = []
    for fam in sorted(fams):
        if fam in pm.helps:
            h = pm.helps[fam].replace("\\", "\\\\").replace("\n", "\\n")
            lines.append(f"# HELP {fam} {h}")
        if fam in pm.types:
            lines.append(f"# TYPE {fam} {pm.types[fam]}")
        for name, ls in sorted(
            fams[fam], key=lambda p: _sample_sort_key(p[0], p[1])
        ):
            if ls:
                body = ",".join(
                    f'{k}="{_esc_label(v)}"' for k, v in sorted(ls)
                )
                head = f"{name}{{{body}}}"
            else:
                head = name
            line = f"{head} {_fmt_value(pm.samples[(name, ls)])}"
            ex = pm.exemplars.get((name, ls))
            if ex is not None:
                ex_ls, ex_v = ex
                ex_body = ",".join(
                    f'{k}="{_esc_label(v)}"' for k, v in sorted(ex_ls)
                )
                line += f" # {{{ex_body}}}"
                if ex_v is not None:
                    line += f" {_fmt_value(ex_v)}"
            lines.append(line)
    return lines
