"""ObjectDetector — port of ``analytics_zoo_tpu/models/image/
objectdetection/object_detector.py``; parity with ``objectdetection/
ObjectDetector.scala`` + ``Postprocessor.scala``: model forward -> decode
-> per-class NMS -> keep-topk, plus save/load through the ZooModel
registry (the JAX package's ``.npz``, both ways).

The decode runs where the model runs: the softmax, the box decode, the
per-class sort and N1's NMS on the model's device, one read of the table
at the end.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass
from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from ...common.zoo_model import ZooModel, register_model
from .bbox import batched_detection_output
from .multibox_loss import MultiBoxLoss
from .ssd import ssd_lite, ssd_vgg

__all__ = ["ObjectDetector", "DetectionOutputParam"]


@dataclass
class DetectionOutputParam:
    """``DetectionOutputParam`` (``Postprocessor.scala``) — postprocess
    knobs."""
    nms_thresh: float = 0.45
    nms_topk: int = 400
    keep_topk: int = 200
    conf_thresh: float = 0.01
    bg_label: int = 0


_TOPOLOGIES = {"ssd-vgg16-300": ssd_vgg, "ssd-lite": ssd_lite}


@register_model
class ObjectDetector(ZooModel):
    """``ObjectDetector(model_name, num_classes)``. Class 0 is background
    (``bgLabel=0``, ``SSD.scala``). ``detect`` returns a fixed
    ``(B, keep_topk, 6)`` table ``[label, score, x1, y1, x2, y2]`` with
    label ``-1`` padding. ``device`` is where the weights live (``cuda``
    unless given)."""

    def __init__(self, model_name: str = "ssd-lite", num_classes: int = 21,
                 resolution: Optional[int] = None,
                 post_param: Union[DetectionOutputParam, Dict[str, Any],
                                   None] = None,
                 name: Optional[str] = None, device=None):
        if model_name not in _TOPOLOGIES:
            raise ValueError(f"unknown topology {model_name!r}; "
                             f"available: {sorted(_TOPOLOGIES)}")
        self.model_name = model_name
        self.num_classes = int(num_classes)
        self.resolution = int(resolution) if resolution else (
            300 if model_name == "ssd-vgg16-300" else 64)
        if isinstance(post_param, dict):   # a saved config's
            post_param = DetectionOutputParam(**post_param)
        self.post_param = post_param or DetectionOutputParam()
        self.priors: Optional[np.ndarray] = None
        self._priors_on: Dict[torch.device, torch.Tensor] = {}
        super().__init__(name=name, device=device)

    def build_model(self):
        net, priors = _TOPOLOGIES[self.model_name](
            num_classes=self.num_classes, resolution=self.resolution,
            device=self.device)
        self.priors = priors
        return net

    def get_config(self) -> Dict[str, Any]:
        return {"model_name": self.model_name,
                "num_classes": self.num_classes,
                "resolution": self.resolution,
                "post_param": asdict(self.post_param)}

    def multibox_loss(self, **kw) -> MultiBoxLoss:
        """The matching loss bound to this model's priors (placed on the
        model's device) — pass to ``compile(loss=...)``."""
        return MultiBoxLoss(self.num_classes, self.priors,
                            bg_label=self.post_param.bg_label,
                            device=self.device, **kw)

    def decode_on_device(self, raw: torch.Tensor,
                         conf_thresh: Optional[float] = None
                         ) -> torch.Tensor:
        """:meth:`decode` of a tensor ``(B, priors, 4 + classes)`` where it
        lies: the detections as a tensor on its device."""
        p = self.post_param
        priors = self._priors_on.get(raw.device)
        if priors is None:
            priors = self._priors_on[raw.device] = torch.from_numpy(
                self.priors).to(raw.device)
        probs = torch.softmax(raw[..., 4:].float(), dim=-1)
        return batched_detection_output(
            raw[..., :4], probs, priors, num_classes=self.num_classes,
            conf_thresh=(p.conf_thresh if conf_thresh is None
                         else conf_thresh),
            nms_thresh=p.nms_thresh, nms_topk=p.nms_topk,
            keep_topk=p.keep_topk, bg_label=p.bg_label)

    def decode(self, raw, conf_thresh: Optional[float] = None) -> np.ndarray:
        """Raw scores (B, priors, 4 + classes) -> detections (B, keep_topk,
        6). The decode half of :meth:`detect`, exposed so out-of-process
        consumers (Cluster Serving clients streaming raw scores) run the
        identical post-processing; it runs on the model's device."""
        raw = (raw if isinstance(raw, torch.Tensor)
               else torch.tensor(np.asarray(raw, np.float32)))
        if raw.dim() == 2:
            raw = raw[None]
        with torch.no_grad():
            det = self.decode_on_device(raw.to(self.device), conf_thresh)
        return det.cpu().numpy()

    def detect(self, images, batch_size: int = 32,
               conf_thresh: Optional[float] = None) -> np.ndarray:
        """Images (B, H, W, 3) -> detections (B, keep_topk, 6): each batch's
        forward and decode on the model's device, one read at the end."""
        x = np.asarray(images, np.float32)
        outs = []
        with torch.no_grad():
            for i in range(0, len(x), batch_size):
                xb = torch.from_numpy(np.ascontiguousarray(
                    x[i:i + batch_size])).to(self.device)
                outs.append(self.decode_on_device(self(xb, training=False),
                                                  conf_thresh))
        return torch.cat(outs).cpu().numpy()
