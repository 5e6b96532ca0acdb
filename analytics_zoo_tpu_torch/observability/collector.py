"""Fleet rollup — the part of ``analytics_zoo_tpu/observability/
collector.py`` that the status CLI (``serving/status.py``) stands on:
:func:`base_url`, :func:`summary_points`, :func:`fleet_rows` and
:func:`endpoint_rows`, copied as they are (pure Python).

Summaries merge count-weighted through
:func:`~.timeseries.rehydrate_digest` + ``QuantileDigest.merge``, so the
fleet percentiles weight every replica by its actual traffic instead of
naively averaging percentiles; counters and gauges sum per labeled
series; histograms report the mean of the summed sums and counts.

The JAX module's continuous half — ``FleetCollector`` (scrapes on a
cadence into time series, behind breakers and the ``collector.scrape``
fault site), ``FleetzServer`` (``/fleetz``) and the alert engine it
feeds — is not ported yet: it comes with fleet serving.
"""

from __future__ import annotations

from typing import Any, Dict, Sequence, Tuple

from .timeseries import rehydrate_digest

__all__ = ["base_url", "summary_points", "fleet_rows", "endpoint_rows"]


def base_url(arg: str) -> str:
    """``host:port`` / bare port / URL → a scrapable base URL."""
    if arg.startswith("http://") or arg.startswith("https://"):
        return arg.rstrip("/").rsplit("/metrics", 1)[0]
    if ":" not in arg:                      # bare port
        arg = f"127.0.0.1:{arg}"
    return f"http://{arg}"


# ---------------------------------------------------------------------------
# fleet rollup helpers
# ---------------------------------------------------------------------------

def summary_points(families: Dict[str, Any],
                   name: str) -> Tuple[Dict[str, float], float]:
    """``({quantile_str: value}, count)`` for one scraped summary
    family."""
    samples = families[name]["samples"]
    qs = {lab["quantile"]: v for s_name, lab, v in samples
          if s_name == name and "quantile" in lab}
    count = next((v for s_name, _, v in samples
                  if s_name == name + "_count"), 0)
    return qs, count


def fleet_rows(scraped: Sequence[Tuple[Any, ...]]):
    """Roll several replicas' scrapes into fleet-wide
    ``(quantile_rows, scalar_rows)``: summaries merge through
    ``QuantileDigest`` (count-weighted rehydration), counters/gauges
    sum per labeled series, histograms report the mean of the summed
    sums/counts. ``scraped`` rows are ``(base, health, status,
    families)`` — the CLI's scrape tuple."""
    merged: Dict[str, list] = {}    # family -> [digest, count]
    sums: Dict[str, float] = {}     # scalar series -> value
    hist: Dict[str, list] = {}      # family -> [count, sum]
    for _base, _health, _status, families in scraped:
        for name in families:
            fam = families[name]
            if fam["type"] == "summary":
                qs, count = summary_points(families, name)
                if not count:
                    continue
                d = rehydrate_digest(qs, count)
                if name in merged:
                    merged[name][0].merge(d)
                    merged[name][1] += count
                else:
                    merged[name] = [d, count]
            elif fam["type"] in ("counter", "gauge"):
                for s_name, lab, v in fam["samples"]:
                    suffix = ("{" + ",".join(
                        f"{k}={vv}" for k, vv in lab.items()) + "}") \
                        if lab else ""
                    key = s_name + suffix
                    sums[key] = sums.get(key, 0.0) + v
            elif fam["type"] == "histogram":
                count = next((v for s_name, _, v in fam["samples"]
                              if s_name == name + "_count"), 0)
                total = next((v for s_name, _, v in fam["samples"]
                              if s_name == name + "_sum"), 0.0)
                h = hist.setdefault(name, [0, 0.0])
                h[0] += count
                h[1] += total
    quantile_rows = [
        (name, count, *(d.quantile(q) * 1000.0 for q in (0.5, 0.95, 0.99)))
        for name, (d, count) in sorted(merged.items())]
    scalar_rows = sorted(sums.items())
    scalar_rows += [(name + " (mean)", h[1] / h[0])
                    for name, h in sorted(hist.items()) if h[0]]
    return quantile_rows, scalar_rows


def endpoint_rows(families: Dict[str, Any]):
    """One endpoint's ``(quantile_rows, scalar_rows)`` — exact
    quantile values straight off the scrape, no rehydration."""
    quantile_rows = []
    scalar_rows = []
    for name in sorted(families):
        fam = families[name]
        samples = fam["samples"]
        if fam["type"] == "summary":
            qs, count = summary_points(families, name)
            if count:
                quantile_rows.append(
                    (name, count, *(qs.get(k, float("nan")) * 1000.0
                                    for k in ("0.5", "0.95", "0.99"))))
        elif fam["type"] in ("counter", "gauge"):
            for s_name, lab, v in samples:
                suffix = ("{" + ",".join(f"{k}={vv}"
                                         for k, vv in lab.items())
                          + "}") if lab else ""
                scalar_rows.append((s_name + suffix, v))
        elif fam["type"] == "histogram":
            count = next((v for s_name, _, v in samples
                          if s_name == name + "_count"), 0)
            total = next((v for s_name, _, v in samples
                          if s_name == name + "_sum"), 0.0)
            if count:
                scalar_rows.append((name + " (mean)", total / count))
    return quantile_rows, scalar_rows
