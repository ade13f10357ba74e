"""Rendering: trend tables (terminal / markdown) and the HTML dashboard
(counterpart of `repro.obs.history.report`, the same text on the same DB).

Both views answer the same question — "where is each series heading, and
did the latest run move it?" — at two fidelities: the table is grep-able
CI-log output (unicode sparkline per series, verdict column), the HTML
report is a single self-contained file (inline CSS + inline SVG
sparklines, zero external assets) that uploads as one CI artifact and
opens anywhere.
"""
from __future__ import annotations

import html as _html

from repro_torch.obs.history.baseline import Thresholds, check_db

_SPARK = "▁▂▃▄▅▆▇█"


def sparkline(values) -> str:
    """Unicode trend strip: each value binned into the series' own
    min..max range (shape, not scale — the table's value columns carry the
    scale)."""
    vals = [float(v) for v in values]
    if not vals:
        return ""
    lo, hi = min(vals), max(vals)
    if hi <= lo:
        return _SPARK[0] * len(vals)
    return "".join(_SPARK[min(int((v - lo) / (hi - lo) * (len(_SPARK) - 1)),
                              len(_SPARK) - 1)] for v in vals)


def _fmt(v: float) -> str:
    a = abs(v)
    if a != 0 and (a >= 1e5 or a < 1e-3):
        return f"{v:.3g}"
    return f"{v:.4g}"


def _series_rows(db, last: int):
    """(series_key, records-window, verdict-status) per series, with the
    verdict map built once from the default-threshold check of the latest
    run."""
    verdicts = {(v.bench, v.row, v.metric, v.device_kind): v
                for v in check_db(db, thresholds=Thresholds())}
    for key, recs in sorted(db.series().items()):
        yield key, recs[-last:], verdicts.get(key)


def trend_table(db, last: int = 10, markdown: bool = False) -> str:
    """One line per series: trend sparkline over the last `last` points,
    latest value, delta vs the rolling baseline, and the verdict of the
    most recent run (blank for series the latest run didn't touch)."""
    header = ["series", "n", "trend", "latest", "baseline", "delta", "verdict"]
    rows = []
    for (bench, row, metric, dev), recs, v in _series_rows(db, last):
        name = f"{bench}/{row}/{metric}" + \
            (f" [{dev}]" if dev != "unknown" else "")
        vals = [r.value for r in recs]
        if v is not None and v.status not in ("no-baseline", "ungated"):
            base, delta = _fmt(v.baseline), f"{v.rel_delta:+.1%}"
            verdict = v.status
        else:
            base, delta = "-", "-"
            verdict = v.status if v is not None else ""
        rows.append([name, str(len(recs)), sparkline(vals), _fmt(vals[-1]),
                     base, delta, verdict])
    if markdown:
        lines = ["| " + " | ".join(header) + " |",
                 "|" + "|".join("---" for _ in header) + "|"]
        lines += ["| " + " | ".join(r) + " |" for r in rows]
        return "\n".join(lines)
    widths = [max(len(header[i]), *(len(r[i]) for r in rows)) if rows
              else len(header[i]) for i in range(len(header))]
    lines = ["  ".join(h.ljust(w) for h, w in zip(header, widths))]
    lines += ["  ".join(c.ljust(w) for c, w in zip(r, widths)) for r in rows]
    return "\n".join(lines)


def _svg_spark(values, width: int = 160, height: int = 28) -> str:
    """Inline SVG polyline of a series (newest right), last point dotted."""
    vals = [float(v) for v in values]
    if len(vals) == 1:
        vals = vals * 2
    lo, hi = min(vals), max(vals)
    span = (hi - lo) or 1.0
    pad = 3
    pts = []
    for i, v in enumerate(vals):
        x = pad + i * (width - 2 * pad) / max(len(vals) - 1, 1)
        y = height - pad - (v - lo) / span * (height - 2 * pad)
        pts.append(f"{x:.1f},{y:.1f}")
    lx, ly = pts[-1].split(",")
    return (f'<svg width="{width}" height="{height}" class="spark">'
            f'<polyline fill="none" stroke="currentColor" stroke-width="1.5" '
            f'points="{" ".join(pts)}"/>'
            f'<circle cx="{lx}" cy="{ly}" r="2.5" fill="currentColor"/></svg>')


_CSS = """
body{font:14px/1.5 -apple-system,Segoe UI,Roboto,sans-serif;margin:2rem;
     color:#1a1a1a;background:#fff}
h1{font-size:1.3rem} h2{font-size:1.05rem;margin:1.6rem 0 .4rem}
table{border-collapse:collapse;width:100%}
th,td{text-align:left;padding:.25rem .6rem;border-bottom:1px solid #e5e5e5;
      white-space:nowrap}
th{font-weight:600;border-bottom:2px solid #bbb}
td.num{font-variant-numeric:tabular-nums}
.spark{color:#4878d0;vertical-align:middle}
.regressed{color:#b4231f;font-weight:600}
.improved{color:#1c7c3c;font-weight:600}
.flat{color:#777}.no-baseline,.ungated{color:#aaa}
.meta{color:#777;font-size:.85rem}
"""


def html_report(db, title: str = "repro-bench perf history",
                last: int = 20) -> str:
    """The whole DB as ONE self-contained HTML page: a section per bench,
    a row per series with an SVG sparkline, the latest value/baseline/
    delta, and the latest run's verdict — colored so a regressed metric is
    findable without reading numbers."""
    sections: dict = {}
    for (bench, row, metric, dev), recs, v in _series_rows(db, last):
        sections.setdefault(bench, []).append((row, metric, dev, recs, v))
    shas = db.shas()
    parts = ["<!doctype html><html><head><meta charset='utf-8'>",
             f"<title>{_html.escape(title)}</title>",
             f"<style>{_CSS}</style></head><body>",
             f"<h1>{_html.escape(title)}</h1>",
             f"<p class='meta'>{len(db)} points · "
             f"{len(db.series())} series · {len(shas)} commits"
             + (f" · latest {_html.escape(shas[-1])}" if shas else "")
             + "</p>"]
    for bench in sorted(sections):
        parts.append(f"<h2>{_html.escape(bench)}</h2>")
        parts.append("<table><tr><th>row</th><th>metric</th><th>trend</th>"
                     "<th>latest</th><th>baseline</th><th>delta</th>"
                     "<th>verdict</th></tr>")
        for row, metric, dev, recs, v in sections[bench]:
            vals = [r.value for r in recs]
            label = _html.escape(metric) + \
                (f" <span class='meta'>[{_html.escape(dev)}]</span>"
                 if dev != "unknown" else "")
            if v is not None and v.status not in ("no-baseline", "ungated"):
                base, delta = _fmt(v.baseline), f"{v.rel_delta:+.1%}"
                status = v.status
            else:
                base, delta = "–", "–"
                status = v.status if v is not None else ""
            parts.append(
                f"<tr><td>{_html.escape(row)}</td><td>{label}</td>"
                f"<td>{_svg_spark(vals)}</td>"
                f"<td class='num'>{_fmt(vals[-1])}</td>"
                f"<td class='num'>{base}</td><td class='num'>{delta}</td>"
                f"<td class='{status}'>{status}</td></tr>")
        parts.append("</table>")
    parts.append("</body></html>")
    return "\n".join(parts)
