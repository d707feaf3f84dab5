"""Side-by-side benchmark comparison (counterpart of
quantizedmha_tpu/profiling/compare.py, tools/compare_ncu.py reborn).

The reference parsed two Nsight-Compute text exports into named tables and
emitted side-by-side markdown with per-table OPT/INF comments
(compare_ncu.py:13-193). Here the inputs are the JSON reports written by
`python -m quantizedmha_tpu_torch.harness --json` or the JAX package's
`qmha-bench --json` (one per run: before/after a kernel change, two block
sizes, two devices) and the output is the same style of markdown diff:
per-kernel rows with both values and the delta, plus captured notes.
"""

from __future__ import annotations

import json
import pathlib
from typing import Optional

_METRICS = [
    # (key, header, unit, higher_is_better)
    ("ms", "latency", "ms", False),
    ("tflops", "achieved", "TFLOP/s", True),
    ("pct_mxu_sol", "MXU SoL", "%", True),
    ("pct_hbm_sol", "HBM SoL", "%", True),
]


def _fmt(v) -> str:
    if v is None:
        return "—"
    return f"{v:.3f}" if isinstance(v, float) else str(v)


def _delta(a, b, higher_is_better: bool) -> str:
    if a is None or b is None or not a:
        return "—"
    pct = (b - a) / a * 100.0
    better = (pct > 0) == higher_is_better and abs(pct) > 0.5
    worse = (pct > 0) != higher_is_better and abs(pct) > 0.5
    marker = " ✓" if better else (" ✗" if worse else "")
    return f"{pct:+.1f}%{marker}"


def compare_reports(
    report_a: dict,
    report_b: dict,
    label_a: str = "A",
    label_b: str = "B",
    notes: Optional[dict] = None,
) -> str:
    """Render two `qmha-bench --json` payloads as a markdown diff."""
    lines = [
        f"# Benchmark comparison: {label_a} vs {label_b}",
        "",
        f"- **{label_a}**: device `{report_a.get('device')}`, "
        f"workload `{report_a.get('workload')}`",
        f"- **{label_b}**: device `{report_b.get('device')}`, "
        f"workload `{report_b.get('workload')}`",
        "",
    ]
    res_a = {r["kernel"]: r for r in report_a.get("results", [])}
    res_b = {r["kernel"]: r for r in report_b.get("results", [])}
    kernels = list(res_a) + [k for k in res_b if k not in res_a]

    for kernel in kernels:
        a, b = res_a.get(kernel, {}), res_b.get(kernel, {})
        lines.append(f"## {kernel}")
        lines.append("")
        lines.append(f"| metric | {label_a} | {label_b} | Δ |")
        lines.append("|---|---|---|---|")
        for key, header, unit, hib in _METRICS:
            va, vb = a.get(key), b.get(key)
            lines.append(
                f"| {header} ({unit}) | {_fmt(va)} | {_fmt(vb)} | "
                f"{_delta(va, vb, hib)} |"
            )
        for side, r, label in (("a", a, label_a), ("b", b, label_b)):
            if r.get("error"):
                lines.append(f"| error ({label}) | `{r['error']}` | | |")
            chk = r.get("check")
            if chk and (chk.get("n_mismatch") or chk.get("n_nonfinite")):
                lines.append(
                    f"| **CHECK FAILED** ({label}) | mismatches="
                    f"{chk['n_mismatch']} nonfinite={chk['n_nonfinite']} | | |"
                )
        note = (notes or {}).get(kernel)
        if note:
            lines.append("")
            lines.append(f"> {note}")
        lines.append("")
    return "\n".join(lines)


def compare_files(
    path_a,
    path_b,
    out: Optional[str] = None,
    notes: Optional[dict] = None,
) -> str:
    a = json.loads(pathlib.Path(path_a).read_text())
    b = json.loads(pathlib.Path(path_b).read_text())
    md = compare_reports(
        a, b, label_a=pathlib.Path(path_a).stem, label_b=pathlib.Path(path_b).stem,
        notes=notes,
    )
    if out:
        pathlib.Path(out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(out).write_text(md)
    return md


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(
        prog="qmha-compare",
        description="Diff two qmha-bench --json reports into markdown "
                    "(tools/compare_ncu.py analog).",
    )
    p.add_argument("report_a")
    p.add_argument("report_b")
    p.add_argument("-o", "--out", default=None, help="write markdown here")
    p.add_argument("--note", action="append", default=[],
                   metavar="KERNEL=TEXT",
                   help="attach a note to a kernel section (repeatable)")
    args = p.parse_args(argv)
    notes = {}
    for item in args.note:
        kernel, _, text = item.partition("=")
        notes[kernel] = text
    md = compare_files(args.report_a, args.report_b, out=args.out, notes=notes)
    if not args.out:
        print(md)
    else:
        print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
