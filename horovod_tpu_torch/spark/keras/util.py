"""Keras (de)serialization helpers (the port's copy of
``horovod_tpu/spark/keras/util.py``, after upstream Horovod's
``spark/keras/util.py`` and ``serialization.py``): models and optimizers
move from the driver to the workers as bytes.
"""

from __future__ import annotations

import io
import os
import tempfile


def serialize_model(model) -> bytes:
    """Keras 3 native .keras archive as bytes."""
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "model.keras")
        model.save(path)
        with open(path, "rb") as f:
            return f.read()


def deserialize_model(blob: bytes, custom_objects=None):
    import keras

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "model.keras")
        with open(path, "wb") as f:
            f.write(blob)
        return keras.models.load_model(
            path, custom_objects=custom_objects, compile=True)


def serialize_optimizer(optimizer) -> bytes:
    import json

    import keras

    cfg = keras.optimizers.serialize(optimizer)
    return json.dumps(cfg).encode()


def deserialize_optimizer(blob: bytes):
    import json

    import keras

    return keras.optimizers.deserialize(json.loads(blob.decode()))
