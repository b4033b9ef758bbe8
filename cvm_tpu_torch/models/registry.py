"""Model-zoo registry: name -> params class, model builder, loss, processor
and decode.

Mirrors ``cvm_tpu/models/registry.py`` (``ModelSpec``, ``get_model``,
``get_model_zoo``, ``build_model``) for the whole zoo: centernet (with its
optional 3D heads), semseg, depth, multitask and dmds.
``create_model(params, device, generator=None)`` takes the device the model
lives on; a multi-process run builds the whole model on every rank, then
cuts its tensor-parallel slices (``parallel/sharding.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    name: str
    params_cls: type
    create_model: Callable[..., Any]
    loss_fn: Callable[..., Any]
    make_processor: Callable[[Any, bool], Callable]
    decode_fn: Optional[Callable[..., Any]] = None


_REGISTRY: Dict[str, Callable[[], ModelSpec]] = {}


def register_model(name: str, builder: Callable[[], ModelSpec]) -> None:
    _REGISTRY[name] = builder


def get_model(name: str) -> ModelSpec:
    if name not in _REGISTRY:
        raise KeyError(f"unknown model {name!r}; available: {sorted(_REGISTRY)}")
    return _REGISTRY[name]()


def get_model_zoo():
    return sorted(_REGISTRY)


def build_model(spec: ModelSpec, cfg, device, generator=None, mesh=None):
    """``spec.create_model`` on ``device``, weights drawn from
    ``generator`` (seed 0 when None), passing ``mesh`` through for the
    configs whose layout needs it (semseg's ``spatial_shard`` head)."""
    if mesh is not None and getattr(cfg, "spatial_shard", False):
        return spec.create_model(cfg, device, generator, mesh=mesh)
    return spec.create_model(cfg, device, generator)


def _centernet() -> ModelSpec:
    from cvm_tpu_torch.models.centernet.loss import centernet_loss
    from cvm_tpu_torch.models.centernet.model import create_model
    from cvm_tpu_torch.models.centernet.params import CenternetParams
    from cvm_tpu_torch.models.centernet.processor import make_processor
    from cvm_tpu_torch.ops.decode import decode_centernet

    return ModelSpec("centernet", CenternetParams, create_model, centernet_loss,
                     make_processor, decode_centernet)


def _semseg() -> ModelSpec:
    from cvm_tpu_torch.models.semseg.loss import semseg_loss
    from cvm_tpu_torch.models.semseg.model import create_model
    from cvm_tpu_torch.models.semseg.params import SemsegParams
    from cvm_tpu_torch.models.semseg.processor import make_processor
    from cvm_tpu_torch.ops.decode import semseg_argmax

    return ModelSpec("semseg", SemsegParams, create_model, semseg_loss, make_processor,
                     semseg_argmax)


def _depth() -> ModelSpec:
    from cvm_tpu_torch.models.depth.loss import depth_loss
    from cvm_tpu_torch.models.depth.model import create_model
    from cvm_tpu_torch.models.depth.params import DepthParams
    from cvm_tpu_torch.models.depth.processor import make_processor

    return ModelSpec("depth", DepthParams, create_model, depth_loss, make_processor)


def _multitask() -> ModelSpec:
    from cvm_tpu_torch.models.multitask.loss import multitask_loss
    from cvm_tpu_torch.models.multitask.model import create_model
    from cvm_tpu_torch.models.multitask.params import MultitaskParams
    from cvm_tpu_torch.models.multitask.processor import make_processor

    return ModelSpec("multitask", MultitaskParams, create_model, multitask_loss,
                     make_processor)


def _dmds() -> ModelSpec:
    from cvm_tpu_torch.models.dmds.loss import dmds_loss
    from cvm_tpu_torch.models.dmds.model import create_model
    from cvm_tpu_torch.models.dmds.params import DmdsParams
    from cvm_tpu_torch.models.dmds.processor import make_processor

    return ModelSpec("dmds", DmdsParams, create_model, dmds_loss, make_processor)


register_model("centernet", _centernet)
register_model("semseg", _semseg)
register_model("depth", _depth)
register_model("multitask", _multitask)
register_model("dmds", _dmds)
