"""Net — the model-import facade — port of ``analytics_zoo_tpu/pipeline/
api/net.py`` (``Net.load`` / ``load_caffe`` / ``load_onnx`` / ``load_tf``
/ ``load_torch``, ``Net.scala:123-171``), ``TorchNet``
(``TorchNet.scala``) and ``TorchCriterion`` (``TorchCriterion.scala``).

An imported model becomes the port's own layers, as in the JAX package:
``TorchNet.from_module`` maps the common ``torch.nn`` module types onto
``Dense``, ``Convolution2D``, ``BatchNormalization`` ... with the weights
translated into the JAX layouts (a Linear's weight transposed to
``(in, out)``, a Conv2d's OIHW to HWIO), so the ``.npz`` and
``load_jax_params`` stay the format both packages read. Image graphs run
NHWC (the port's ``channels_last`` convolutions) and take NHWC input; a
``Flatten`` after an image stream first transposes to NCHW so the next
Linear's weights line up. The source module may sit on any device: its
weights are read with ``.detach().cpu()``.

``TorchCriterion`` translates a torch loss onto torch ops of the port's
own (never calling the loss module at step time), so it runs inside a
captured training step as ``CustomLoss`` does.
"""

from __future__ import annotations

import os
from typing import Any, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from .keras.engine import (Input, KerasNet, Lambda, Model,
                           install_imported_weights)
from .keras.layers import (Activation, AveragePooling2D, BatchNormalization,
                           Convolution2D, Dense, Dropout, Embedding, Flatten,
                           GlobalAveragePooling2D, LayerNorm, LeakyReLU,
                           MaxPooling2D, ZeroPadding2D)
from .keras.objectives import _pick

__all__ = ["Net", "TorchNet", "TorchCriterion"]


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def _pair(v):
    return v if isinstance(v, tuple) else (v, v)


class TorchNet:
    """``TorchNet.from_module(torch_module, input_shape)`` — convert a torch
    module tree into a graph ``Model`` of the port's layers with the
    pretrained weights stashed for install. ``input_shape`` excludes the
    batch dim and uses the TORCH convention (``(3, 224, 224)`` for
    images); image graphs run NHWC and take NHWC input."""

    SUPPORTED = ("Sequential, Linear, Conv2d, BatchNorm1d/2d, LayerNorm, "
                 "Embedding, ReLU, LeakyReLU, Sigmoid, Tanh, Softmax, "
                 "GELU, MaxPool2d, AvgPool2d, AdaptiveAvgPool2d(1), "
                 "Flatten, Dropout, Identity")

    @staticmethod
    def _is(m, cls) -> bool:
        """isinstance that also recognises TorchScript modules by their
        ``original_name`` (``torch.jit.script`` keeps the
        ``__constants__`` the converters read; traced modules lose them —
        see ``from_torchscript``)."""
        if isinstance(cls, tuple):
            return any(TorchNet._is(m, c) for c in cls)
        if isinstance(m, cls):
            return True
        return getattr(m, "original_name", None) == cls.__name__

    @staticmethod
    def from_module(module, input_shape: Sequence[int],
                    device=None) -> KerasNet:
        """The graph ``Model`` (on ``device``: ``cuda`` unless given) of
        ``module``; :meth:`Net.load_torch` also installs the weights."""
        import torch.nn as nn

        mods = (list(module.children())
                if TorchNet._is(module, nn.Sequential) else [module])
        mods = TorchNet._flatten(mods, nn)

        shape = tuple(int(d) for d in input_shape)
        if len(shape) == 3:
            c, h, w = shape
            inp = Input(shape=(h, w, c), name="input")
        else:
            inp = Input(shape=shape, name="input")
        x = inp
        # the torch-convention shape (sans batch) threaded through the
        # conversion: conv/pool arithmetic, the flatten order and the axis
        # decisions (BatchNorm1d, Softmax) read it
        tshape: Optional[tuple] = shape
        for i, m in enumerate(mods):
            name = f"torch{i}_{type(m).__name__.lower()}"
            x, tshape = TorchNet._convert(m, x, name, tshape, nn)
        return Model(input=inp, output=x, device=device)

    @staticmethod
    def from_torchscript(path_or_module, input_shape: Sequence[int],
                         device=None) -> KerasNet:
        """Load a ``torch.jit.save``d module file (on the CPU) and convert
        it as :meth:`from_module` does. ``torch.jit.script``-ed modules keep
        the ``__constants__`` the converters read (kernel sizes, strides,
        eps); ``torch.jit.trace``-d modules drop them into the graph and
        fail with a message saying so."""
        m = path_or_module
        if isinstance(m, (str, bytes)):
            m = torch.jit.load(os.fsdecode(m), map_location="cpu")
        try:
            return TorchNet.from_module(m, input_shape, device=device)
        except AttributeError as e:
            raise NotImplementedError(
                f"TorchScript module is missing a converter attribute "
                f"({e}) — traced modules lose their __constants__; "
                f"re-export with torch.jit.script, or pass the live "
                f"nn.Module") from e

    @staticmethod
    def _flatten(mods, nn) -> List[Any]:
        out = []
        for m in mods:
            if TorchNet._is(m, nn.Sequential):
                out.extend(TorchNet._flatten(list(m.children()), nn))
            else:
                out.append(m)
        return out

    # -- per-module conversion ---------------------------------------------
    @staticmethod
    def _convert(m, x, name, tshape, nn):
        is_ = TorchNet._is
        if is_(m, nn.Linear):
            layer = Dense(m.out_features, bias=m.bias is not None, name=name)
            w = {"W": _np(m.weight).T}
            if m.bias is not None:
                w["b"] = _np(m.bias)
            layer._pretrained = w
            return layer(x), (m.out_features,)
        if is_(m, nn.Conv2d):
            if m.groups != 1:
                raise NotImplementedError(f"{name}: grouped torch Conv2d")
            if m.padding_mode != "zeros":
                raise NotImplementedError(
                    f"{name}: padding_mode={m.padding_mode!r} (only zeros)")
            if isinstance(m.padding, str):
                raise NotImplementedError(f"{name}: string padding mode")
            ph, pw = _pair(m.padding)
            if (ph, pw) != (0, 0):
                x = ZeroPadding2D((ph, pw), name=f"{name}_pad")(x)
            layer = Convolution2D(
                m.out_channels, m.kernel_size[0], m.kernel_size[1],
                subsample=tuple(m.stride), border_mode="valid",
                dilation=tuple(m.dilation), bias=m.bias is not None,
                name=name)
            w = {"W": np.transpose(_np(m.weight), (2, 3, 1, 0))}
            if m.bias is not None:
                w["b"] = _np(m.bias)
            layer._pretrained = w
            if tshape is not None and len(tshape) == 3:
                _, h, wd = tshape
                h2 = (h + 2 * ph - m.dilation[0] * (m.kernel_size[0] - 1)
                      - 1) // m.stride[0] + 1
                w2 = (wd + 2 * pw - m.dilation[1] * (m.kernel_size[1] - 1)
                      - 1) // m.stride[1] + 1
                tshape = (m.out_channels, h2, w2)
            else:
                tshape = None
            return layer(x), tshape
        if is_(m, (nn.BatchNorm1d, nn.BatchNorm2d)):
            if not m.track_running_stats:
                raise NotImplementedError(
                    f"{name}: BatchNorm(track_running_stats=False) has no "
                    f"inference-time statistics to import")
            # BatchNorm1d over a (N, C, L) stream normalises axis 1; on a
            # 2D (N, C) stream the channel axis IS the last one. Image
            # streams run NHWC, so BatchNorm2d normalises -1.
            axis = 1 if (is_(m, nn.BatchNorm1d) and tshape is not None
                         and len(tshape) == 2) else -1
            layer = BatchNormalization(epsilon=m.eps, axis=axis,
                                       scale=m.affine, center=m.affine,
                                       name=name)
            if m.affine:
                layer._pretrained = {"gamma": _np(m.weight),
                                     "beta": _np(m.bias)}
            layer._pretrained_state = {"moving_mean": _np(m.running_mean),
                                       "moving_var": _np(m.running_var)}
            return layer(x), tshape
        if is_(m, nn.LayerNorm):
            layer = LayerNorm(epsilon=m.eps, name=name)
            if m.elementwise_affine:
                layer._pretrained = {"gamma": _np(m.weight),
                                     "beta": _np(m.bias)}
            return layer(x), tshape
        if is_(m, nn.Embedding):
            layer = Embedding(m.num_embeddings, m.embedding_dim, name=name)
            layer._pretrained = {"embeddings": _np(m.weight)}
            return layer(x), (tshape + (m.embedding_dim,)
                              if tshape is not None else None)
        if is_(m, nn.ReLU):
            return Activation("relu", name=name)(x), tshape
        if is_(m, nn.LeakyReLU):
            return LeakyReLU(m.negative_slope, name=name)(x), tshape
        if is_(m, nn.Sigmoid):
            return Activation("sigmoid", name=name)(x), tshape
        if is_(m, nn.Tanh):
            return Activation("tanh", name=name)(x), tshape
        if is_(m, nn.Softmax):
            # the port's softmax runs over the LAST axis; refuse any other
            last = len(tshape) if tshape is not None else None
            if m.dim not in (-1, last):
                raise NotImplementedError(
                    f"{name}: Softmax(dim={m.dim}) — only the last axis "
                    f"maps onto the native layer")
            return Activation("softmax", name=name)(x), tshape
        if is_(m, nn.GELU):
            approx = ("tanh" if getattr(m, "approximate", "none") == "tanh"
                      else "none")
            return Lambda(lambda t, a=approx: F.gelu(t, approximate=a),
                          name=name)(x), tshape
        if is_(m, nn.MaxPool2d) or is_(m, nn.AvgPool2d):
            k = _pair(m.kernel_size)
            s = (m.stride if isinstance(m.stride, tuple)
                 else (m.stride or m.kernel_size,) * 2)
            p = _pair(m.padding)
            if getattr(m, "ceil_mode", False):
                raise NotImplementedError(f"{name}: ceil_mode pooling")
            if getattr(m, "dilation", 1) not in (1, (1, 1)):
                raise NotImplementedError(f"{name}: dilated pooling")
            if getattr(m, "return_indices", False):
                raise NotImplementedError(f"{name}: return_indices pooling")
            if is_(m, nn.AvgPool2d) and not m.count_include_pad:
                raise NotImplementedError(
                    f"{name}: AvgPool2d(count_include_pad=False)")
            if p != (0, 0):
                # zero pad + valid pool = torch's floor mode with
                # count_include_pad=True (its default)
                x = ZeroPadding2D(p, name=f"{name}_pad")(x)
            pool_cls = (MaxPooling2D if is_(m, nn.MaxPool2d)
                        else AveragePooling2D)
            node = pool_cls(k, strides=s, border_mode="valid", name=name)(x)
            if tshape is not None and len(tshape) == 3:
                c, h, w = tshape
                tshape = (c, (h + 2 * p[0] - k[0]) // s[0] + 1,
                          (w + 2 * p[1] - k[1]) // s[1] + 1)
            else:
                tshape = None
            return node, tshape
        if is_(m, nn.AdaptiveAvgPool2d):
            if m.output_size not in (1, (1, 1)):
                raise NotImplementedError(f"{name}: adaptive pool to "
                                          f"{m.output_size}")
            node = GlobalAveragePooling2D(name=name)(x)
            return node, ((tshape[0],) if tshape is not None
                          and len(tshape) == 3 else None)
        if is_(m, nn.Flatten):
            if (m.start_dim, m.end_dim) != (1, -1):
                raise NotImplementedError(
                    f"{name}: Flatten(start_dim={m.start_dim}, "
                    f"end_dim={m.end_dim}) — only full flatten")
            if tshape is not None and len(tshape) == 3:
                # torch flattens in NCHW C*H*W order: transpose first so
                # the following Linear's pretrained weights line up
                x = Lambda(lambda t: t.permute(0, 3, 1, 2),
                           name=f"{name}_nchw")(x)
            flat = (int(np.prod(tshape)),) if tshape is not None else None
            return Flatten(name=name)(x), flat
        if is_(m, nn.Dropout):
            return Dropout(m.p, name=name)(x), tshape
        if is_(m, nn.Identity):
            return x, tshape
        raise NotImplementedError(
            f"torch module {type(m).__name__} not supported; supported: "
            f"{TorchNet.SUPPORTED}")


def _install_pretrained(model: KerasNet) -> KerasNet:
    """Init ``model``, then install the weights (and running statistics)
    the converters stashed on its layers, through the shared
    shape-checked installer; the stashes are dropped after."""
    weights, states = {}, {}
    for node in model._topo:
        layer = node.layer
        for attr, into in (("_pretrained", weights),
                           ("_pretrained_state", states)):
            got = layer.__dict__.pop(attr, None)
            if got is not None:
                into[layer.name] = got
    return install_imported_weights(model, weights, states, source="torch")


class Net:
    """The loader facade (``Net.scala:123-171``). Every entry point builds
    on ``device``: ``cuda`` unless given."""

    @staticmethod
    def load(path: str, device=None):
        """A model saved by this framework (a ZooModel ``.npz``)."""
        from ...models.common.zoo_model import load_model
        return load_model(path, device=device)

    @staticmethod
    def load_caffe(model_path: str,
                   input_shape: Optional[Sequence[int]] = None, device=None):
        raise NotImplementedError(
            "Net.load_caffe: the Caffe importer is not ported yet (queue 1 "
            "item 10f)")

    @staticmethod
    def load_onnx(path: str, device=None):
        raise NotImplementedError(
            "Net.load_onnx: the ONNX importer is not ported yet (queue 1 "
            "item 10f)")

    @staticmethod
    def load_torch(module, input_shape: Sequence[int],
                   device=None) -> KerasNet:
        """An in-memory ``torch.nn`` module OR a TorchScript file path
        (``Net.loadTorch``), converted and with its weights installed."""
        if isinstance(module, (str, bytes)):
            model = TorchNet.from_torchscript(module, input_shape,
                                              device=device)
        else:
            model = TorchNet.from_module(module, input_shape, device=device)
        return _install_pretrained(model)

    @staticmethod
    def load_tf(path: str, inputs=None, outputs=None, trainable: bool = True,
                device=None, **kwargs):
        """A frozen TF GraphDef ``.pb`` (``Net.loadTF``) or a SavedModel
        DIRECTORY (``TFNetForInference.scala:412`` role: graph and restored
        variables, fine-tunable), run as torch ops with no TF runtime; see
        ``tfnet.py`` and ``saved_model.py``. The result is a ``TFNet``
        layer with its weights on ``device`` (``cuda`` unless given):
        call it, or stack it in a ``Sequential`` or a graph ``Model``."""
        if os.path.isdir(path):
            from .saved_model import load_saved_model
            return load_saved_model(path, inputs=inputs, outputs=outputs,
                                    trainable=trainable, device=device,
                                    **kwargs)
        if kwargs:
            raise TypeError(f"unexpected arguments for a frozen GraphDef "
                            f"file: {sorted(kwargs)} (signature/tags apply "
                            f"to SavedModel directories only)")
        from .tfnet import load_tf
        return load_tf(path, inputs=inputs, outputs=outputs,
                       trainable=trainable, device=device)


class TorchCriterion:
    """``TorchCriterion.scala`` role — a torch LOSS for ``compile()``.

    The loss is TRANSLATED once onto the port's own torch ops (the torch
    loss module is never called at step time, so a captured step holds
    it): pass a ``torch.nn`` loss module, its class name, or a
    TorchScript file of one. Covered: MSELoss, L1Loss, SmoothL1Loss,
    CrossEntropyLoss (logits + int labels), NLLLoss (log-probs + int
    labels), BCELoss, BCEWithLogitsLoss. ``reduction`` mean/sum matches
    torch: over ELEMENTS for the elementwise losses, over examples for the
    class-indexed ones. Computed in float32. A class label outside
    ``[-C, C)`` gives a NaN loss for its row, as the JAX gather does
    (``objectives._pick``).

    >>> model.compile(optimizer="adam", loss=TorchCriterion(nn.MSELoss()))
    """

    def __init__(self, loss):
        if isinstance(loss, bytes):
            loss = loss.decode()
        if isinstance(loss, str) and (loss.endswith((".pt", ".pth"))
                                      or os.path.exists(loss)):
            loss = torch.jit.load(loss, map_location="cpu")
        name = (loss if isinstance(loss, str)
                else getattr(loss, "original_name", None)
                or type(loss).__name__)
        reduction = getattr(loss, "reduction", "mean")
        if reduction not in ("mean", "sum"):
            raise NotImplementedError(
                f"TorchCriterion: reduction={reduction!r} (mean|sum)")
        # options the translation does NOT carry must refuse, not silently
        # train another objective than the torch loss handed in
        for attr, neutral in (("weight", None), ("pos_weight", None),
                              ("ignore_index", -100),
                              ("label_smoothing", 0.0)):
            val = getattr(loss, attr, neutral)
            non_neutral = (val is not None if neutral is None
                           else val is not None and float(val) != neutral)
            if non_neutral:
                raise NotImplementedError(
                    f"TorchCriterion: {name}({attr}={val!r}) is not "
                    f"translated; drop the option or use a native loss")
        table = {
            "MSELoss": self._mse,
            "L1Loss": self._l1,
            "SmoothL1Loss": self._smooth_l1(getattr(loss, "beta", 1.0)),
            "CrossEntropyLoss": self._ce_from_logits,
            "NLLLoss": self._nll,
            "BCELoss": self._bce,
            "BCEWithLogitsLoss": self._bce_logits,
        }
        if name not in table:
            raise NotImplementedError(
                f"TorchCriterion: unsupported torch loss {name!r}; "
                f"supported: {sorted(table)}")
        self.name = name
        self.reduction = reduction
        self._unreduced = table[name]

        def per_example(y_true, y_pred):
            """The per-row statistic ``evaluate`` masks padded rows out of:
            the mean over the non-batch axes (for ``reduction="sum"`` the
            scalar form still sums, as torch does)."""
            un = self._unreduced(*_f32(y_true, y_pred))
            if un.dim() <= 1:
                return un
            return un.reshape(un.shape[0], -1).mean(dim=-1)

        self.per_example = per_example

    # -- unreduced forms (y_true, y_pred float32 on one device) -------------
    @staticmethod
    def _mse(yt, yp):
        return (yp - yt) ** 2

    @staticmethod
    def _l1(yt, yp):
        return torch.abs(yp - yt)

    @staticmethod
    def _smooth_l1(beta):
        if beta == 0.0:          # torch documents beta=0 as exactly L1
            return TorchCriterion._l1

        def fn(yt, yp):
            d = torch.abs(yp - yt)
            return torch.where(d < beta, 0.5 * d ** 2 / beta,
                               d - 0.5 * beta)
        return fn

    @staticmethod
    def _bce(yt, yp):
        # torch's BCELoss clamps the LOG terms at -100, not the probability
        logp = torch.clamp(torch.log(torch.clamp(yp, min=0.0)), min=-100.0)
        log1mp = torch.clamp(torch.log(torch.clamp(1 - yp, min=0.0)),
                             min=-100.0)
        return -(yt * logp + (1 - yt) * log1mp)

    @staticmethod
    def _bce_logits(yt, yp):
        return (torch.clamp(yp, min=0) - yp * yt
                + torch.log1p(torch.exp(-torch.abs(yp))))

    @staticmethod
    def _ce_from_logits(yt, yp):
        return TorchCriterion._nll(yt, torch.log_softmax(yp, dim=-1))

    @staticmethod
    def _nll(yt, yp):
        return -_pick(yp, yt.to(torch.int32).reshape(-1))

    def __call__(self, y_true, y_pred):
        un = self._unreduced(*_f32(y_true, y_pred))
        return torch.sum(un) if self.reduction == "sum" else torch.mean(un)


def _f32(y_true, y_pred):
    """``(y_true, y_pred)`` as float32 tensors on ``y_pred``'s device;
    labels truncate toward zero where a loss reads them as classes."""
    y_pred = torch.as_tensor(y_pred).float()
    return torch.as_tensor(y_true, device=y_pred.device).float(), y_pred
