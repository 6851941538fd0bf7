"""mx.gluon.model_zoo.vision (counterpart of `mxnet_tpu/gluon/model_zoo/
vision/__init__.py`): the ResNet constructors and `get_model`.

The models are built uninitialised, as in Gluon: `initialize(ctx=...)`
or `load_parameters(file, ctx=...)` puts the weights on a device. The
model store (`pretrained=True`) and the other families of the JAX zoo
(AlexNet, VGG, SqueezeNet, DenseNet, MobileNet, Inception, the detection
names) are not ported yet (ROADMAP.md, Queue 1).
"""
import functools

from ....base import MXNetError
from .resnet import *        # noqa: F401,F403
from .resnet import __all__ as _resnet_all

__all__ = list(_resnet_all) + ["get_model"]

_RESNETS = {f"resnet{n}_v{v}": f"resnet{n}_v{v}"
            for n in (18, 34, 50, 101, 152) for v in (1, 2)}


def _constructor(name, make):
    """The JAX zoo's signature: `pretrained` and `root` for the model
    store, `ctx` to move already-initialised parameters."""
    @functools.wraps(make)
    def ctor(pretrained=False, ctx=None, root=None, **kwargs):
        if pretrained:
            raise MXNetError(f"{name}(pretrained=True): the model store is "
                             f"not ported yet (ROADMAP.md, Queue 1: the "
                             f"model store); train from scratch or "
                             f"load_parameters a JAX save_parameters file")
        net = make(**kwargs)
        if ctx is not None:
            net.collect_params().reset_ctx(ctx)
        return net
    return ctor


_models = {name: _constructor(name, globals()[fn])
           for name, fn in _RESNETS.items()}
for _name, _ctor in _models.items():
    globals()[_name] = _ctor
del _name, _ctor


def get_model(name, **kwargs):
    """A zoo model by name (the ResNet names of the JAX zoo)."""
    key = name.lower()
    if key not in _models:
        raise MXNetError(f"model {name!r} is not in the port's zoo "
                         f"({sorted(_models)}); the other families are in "
                         f"ROADMAP.md, Queue 1 (long tail: the model zoo)")
    return _models[key](**kwargs)
