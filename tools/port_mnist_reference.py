"""The JAX package's MLP-on-MNIST accuracy on the CPU: the reference that
`chip_smoke.py`'s `phase_mnist` holds the PyTorch/CUDA port to
(`MNIST_JAX_TEST_ACC`).

    JAX_PLATFORMS=cpu python tools/port_mnist_reference.py

The flow of examples/train_mnist.py at bench_mlp.py's width and
chip_smoke.py's settings: `models.mlp.get_mlp((512, 256))`, Xavier after
`mx.random.seed(0)`, SGD lr 0.1 momentum 0.9, batch 512, synthetic
`MNIST(train=True)` through `DataLoader(shuffle=True)` after numpy seed
0, 2 epochs; after each, the accuracy on the 10000 `MNIST(train=False)`
images. Prints one JSON line an epoch (train and test accuracy, the
first 5 losses, seconds). About 4 minutes on a few CPU cores.
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402

import mxnet_tpu as mx  # noqa: E402
from mxnet_tpu import autograd, gluon  # noqa: E402
from mxnet_tpu.models.mlp import get_mlp  # noqa: E402

HIDDEN, BATCH, EPOCHS, LR, MOMENTUM, SEED = (512, 256), 512, 2, 0.1, 0.9, 0


def main():
    mx.random.seed(0)
    net = get_mlp(HIDDEN)
    net.initialize(mx.init.Xavier())

    def scale(x):
        return x.astype("float32") / 255.0
    train = gluon.data.vision.MNIST(train=True).transform_first(scale)
    test = gluon.data.vision.MNIST(train=False).transform_first(scale)
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": LR, "momentum": MOMENTUM})
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    np.random.seed(SEED)
    for epoch in range(EPOCHS):
        metric, t0, first = mx.metric.Accuracy(), time.time(), []
        for x, y in gluon.data.DataLoader(train, batch_size=BATCH,
                                          shuffle=True):
            with autograd.record():
                out = net(x)
                loss = loss_fn(out, y)
            loss.backward()
            trainer.step(x.shape[0])
            metric.update([y], [out])
            if len(first) < 5:
                first.append(float(loss.mean().asscalar()))
        test_acc = mx.metric.Accuracy()
        for x, y in gluon.data.DataLoader(test, batch_size=1000):
            test_acc.update([y], [net(x)])
        print(json.dumps({"epoch": epoch + 1, "train_acc": metric.get()[1],
                          "test_acc": test_acc.get()[1],
                          "first_losses": first,
                          "seconds": time.time() - t0}), flush=True)


if __name__ == "__main__":
    main()
