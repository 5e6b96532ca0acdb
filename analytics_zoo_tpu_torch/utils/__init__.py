"""Shared host-side helpers — port of ``analytics_zoo_tpu/utils`` (so far
the prediction decode rule)."""
