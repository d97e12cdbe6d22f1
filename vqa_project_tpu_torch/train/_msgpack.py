"""Reader of the JAX package's flax-msgpack checkpoints, without flax.

The JAX package writes a checkpoint as ``flax.serialization.
msgpack_serialize`` of ``{params, opt_state, step, epoch, rng, extra}``
(``vqa_project_tpu/train/state.py::save_checkpoint``). The format is
plain msgpack with extension types:

- 1, an array: a packed ``(shape, dtype name, C-order bytes)``;
- 3, a numpy scalar: the same packing with shape ``()``;
- 2, a complex number ``(real, imag)``, which no checkpoint holds and
  this reader refuses.

Arrays over 2**30 bytes are split into ``{"__msgpack_chunked_array__":
True, "shape": {"0": ..}, "chunks": {"0": .., ..}}``, and tuples (an
optax state) become dicts keyed "0", "1", ....

Arrays come back as torch tensors. numpy cannot name ``bfloat16``
without ml_dtypes, so such an array is read as int16 bits and viewed as
``torch.bfloat16`` (the JAX package's ``adam_mu_dtype="bfloat16"``
stores Adam's first moment so).
"""

from __future__ import annotations

import msgpack
import numpy as np
import torch

_EXT_ARRAY, _EXT_COMPLEX, _EXT_SCALAR = 1, 2, 3
_CHUNKED = "__msgpack_chunked_array__"


class _Refused(ValueError):
    """A well-formed value this reader does not take."""


def _array(data: bytes) -> torch.Tensor:
    shape, name, buf = msgpack.unpackb(data, raw=True)
    name = name.decode() if isinstance(name, bytes) else name
    if name == "bfloat16":
        bits = np.frombuffer(buf, np.int16).reshape(shape)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    try:
        dtype = np.dtype(name)
    except TypeError:
        raise _Refused(f"array of dtype {name!r} in the checkpoint; "
                       "numpy dtypes and bfloat16 are read") from None
    if dtype.hasobject or dtype.fields is not None:
        raise _Refused(f"array of dtype {name!r} in the checkpoint")
    return torch.from_numpy(np.frombuffer(buf, dtype).reshape(shape).copy())


def _ext_hook(code: int, data: bytes):
    if code in (_EXT_ARRAY, _EXT_SCALAR):
        return _array(data)
    if code == _EXT_COMPLEX:
        raise _Refused("a complex number in the checkpoint (msgpack "
                       "extension type 2); no model checkpoint holds one")
    raise _Refused(f"unknown msgpack extension type {code}")


def _unchunk(tree):
    """Chunked array leaves joined back into arrays."""
    if not isinstance(tree, dict):
        return tree
    if tree.get(_CHUNKED):
        shape = [int(tree["shape"][str(i)])
                 for i in range(len(tree["shape"]))]
        chunks = [tree["chunks"][str(i)].reshape(-1)
                  for i in range(len(tree["chunks"]))]
        return torch.cat(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def read_flax_msgpack(data: bytes):
    """The tree ``flax.serialization.msgpack_restore`` gives for ``data``,
    with torch tensors for its arrays. Raises ValueError for bytes that
    are not one whole msgpack object of that format."""
    try:
        tree = msgpack.unpackb(data, ext_hook=_ext_hook, raw=False)
    except _Refused:
        raise
    except ValueError as e:     # msgpack's errors for cut or bad bytes
        raise ValueError(f"not a complete flax msgpack checkpoint ({e})"
                         ) from e
    return _unchunk(tree)


def migrate_conv_kernels(tree) -> None:
    """In place: a legacy ``(n, in, d)`` ``conv_kernels`` becomes the fused
    ``(in, n*d)`` one, whose column block n*d:(n+1)*d is kernel n. The
    Adam moments mirror the parameter tree, so they migrate with it
    (``vqa_project_tpu/train/state.py::_migrate_conv_kernels``)."""
    if not isinstance(tree, dict):
        return
    for key, val in tree.items():
        if key == "conv_kernels" and torch.is_tensor(val) and val.dim() == 3:
            n, in_dim, d = val.shape
            tree[key] = val.permute(1, 0, 2).reshape(in_dim, n * d)
        else:
            migrate_conv_kernels(val)
