"""Markdown / LaTeX results tables (contract parity: reference src/utils/_data_utils.py:395-475)."""

from __future__ import annotations

__all__ = ["make_table"]


def _format_value(value) -> str:
    if isinstance(value, float):
        return f"{value:.4f}"
    return str(value) if value is not None else ""


def make_table(result_dict: dict, column: str = "results", sort_results: bool = False) -> str:
    """Render the results (or groups) section of a results dict as a markdown table.

    Columns mirror the reference: Tasks | Version | Filter | n-shot | Metric | ↑ | Value | ± | Stderr
    """
    headers = ["Tasks", "Version", "Filter", "n-shot", "Metric", "", "Value", "", "Stderr"]
    rows: list[list[str]] = []

    keys = result_dict.get(column, {}).keys()
    if sort_results:
        keys = sorted(keys)

    for task_name in keys:
        task_results = dict(result_dict[column][task_name])
        version = result_dict.get("versions", {}).get(task_name, "N/A")
        n_shot = str(result_dict.get("n-shot", {}).get(task_name, ""))
        higher_is_better = result_dict.get("higher_is_better", {}).get(task_name, {})

        metric_items = task_results.items()
        if sort_results:
            metric_items = sorted(metric_items)

        for mf, value in metric_items:
            if mf == "alias":
                continue
            metric, _, filter_name = mf.partition(",")
            if metric.endswith("_stderr"):
                continue
            hib = higher_is_better.get(metric)
            arrow = {True: "↑", False: "↓"}.get(hib, " ")
            stderr = task_results.get(f"{metric}_stderr,{filter_name}", "N/A")
            alias = task_results.get("alias", task_name)
            rows.append(
                [
                    alias,
                    str(version),
                    filter_name,
                    n_shot,
                    metric,
                    arrow,
                    _format_value(value),
                    "±" if stderr != "N/A" else "",
                    _format_value(stderr) if stderr != "N/A" else "",
                ]
            )

    widths = [max(len(h), *(len(r[i]) for r in rows)) if rows else len(h) for i, h in enumerate(headers)]
    lines = [
        "|" + "|".join(h.ljust(w) for h, w in zip(headers, widths)) + "|",
        "|" + "|".join("-" * w for w in widths) + "|",
    ]
    for row in rows:
        lines.append("|" + "|".join(c.ljust(w) for c, w in zip(row, widths)) + "|")
    return "\n".join(lines)
