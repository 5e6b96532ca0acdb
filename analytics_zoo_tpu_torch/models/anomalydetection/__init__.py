"""Port of ``analytics_zoo_tpu/models/anomalydetection``:
``AnomalyDetector`` with ``unroll`` and ``detect_anomalies``."""

from .anomaly_detector import AnomalyDetector, detect_anomalies, unroll  # noqa: F401
