"""The operations and bytes that the model's work needs, from its shapes.

Frozen arithmetic, the yardstick of ``kernels.roofline.*`` and
``mfu.*``: a change to the program cannot move it. It counts what the
inputs need, whatever kernels do the work: each input byte read once
and each output byte written once, parameters in float32 (read once a
forward, their gradient written once a step), activations of the
bfloat16 products in bfloat16 and the adjacency, selection, pseudo-
coordinates and logits in float32; each aggregation over the m selected
neighbours only; the GRU over each row's own length. Elementwise
arithmetic is left out, so the least time stays a lower bound.

``m`` is a configuration's model section (``portbench/configs``).
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence

from portbench.counts import peaks

BF16, F32 = 2, 4


class Op(NamedTuple):
    name: str
    flops: float
    nbytes: float
    peak: str = "bf16"      # the rate of its products

    def seconds(self) -> float:
        """The least time: the larger of operations over the peak rate
        and bytes over the memory bandwidth."""
        return max(self.flops / peaks.FLOPS[self.peak],
                   self.nbytes / peaks.HBM_BYTES)


class Product(NamedTuple):
    """One product of the forward: its operations, the bytes of its
    activation input, weight and output, and which gradients a training
    step needs (of the input, of the weight)."""
    name: str
    flops: float
    x_bytes: float
    w_bytes: float
    y_bytes: float
    dx: bool
    dw: bool


def n_params(m: dict) -> int:
    h, e, f = m["hid_dim"], m["emb_dim"], m["feat_dim"]
    c, n, o, v = m["combined_dim"], m["n_kernels"], m["out_dim"], m["vocab_size"]
    gru = 3 * h * e + 3 * h * h + 6 * h
    edge = c * (f + h) + 2 * c + c * c + 2 * c
    conv = f * 2 * h + 2 * h * h + 8 * n
    outs = o * h + 2 * o + o * o + 2 * o
    return v * e + gru + edge + conv + outs


def products(m: dict, b: int, qsum: int) -> List[Product]:
    """The forward's products for b rows whose question lengths sum to
    qsum."""
    h, e, f = m["hid_dim"], m["emb_dim"], m["feat_dim"]
    c, o = m["combined_dim"], m["out_dim"]
    k, nb = m["n_obj"], m["neighbourhood_size"]
    nodes = b * k * f * BF16
    return [
        Product("gru_input", 2 * qsum * e * 3 * h, qsum * e * F32,
                3 * h * e * F32, qsum * 3 * h * F32, True, True),
        Product("gru_recurrence", 2 * qsum * h * 3 * h, qsum * 3 * h * F32,
                3 * h * h * F32, b * h * F32, True, True),
        Product("edge_layer_1", 2 * b * k * f * c + 2 * b * h * c,
                nodes + b * h * F32, c * (f + h) * F32, b * k * c * BF16,
                True, True),
        Product("edge_layer_2", 2 * b * k * c * c, b * k * c * BF16,
                c * c * F32, b * k * c * BF16, True, True),
        Product("adjacency", 2 * b * k * k * c, b * k * c * BF16, 0,
                b * k * k * F32, True, False),
        Product("conv1_projection", 2 * b * k * f * 2 * h, nodes,
                2 * h * f * F32, b * k * 2 * h * BF16, False, True),
        Product("conv1_aggregation", 2 * b * k * nb * 2 * h,
                b * k * 2 * h * BF16 + b * k * k * 3 * F32, 0,
                b * k * 2 * h * BF16, True, False),
        Product("conv2_projection", 2 * b * k * 2 * h * h,
                b * k * 2 * h * BF16, h * 2 * h * F32, b * k * h * BF16,
                True, True),
        Product("conv2_aggregation", 2 * b * k * nb * h,
                b * k * h * BF16 + b * k * k * 3 * F32, 0,
                b * k * h * BF16, True, False),
        Product("out_1", 2 * b * h * o, b * h * F32, o * h * F32,
                b * o * BF16, True, True),
        Product("out_2", 2 * b * o * o, b * o * BF16, o * o * F32,
                b * o * F32, True, True),
    ]


def image_op(m: dict, b: int) -> Op:
    """The image rows a forward reads, gathered from the device table:
    table rows and boxes in, node rows and boxes out."""
    k, f = m["n_obj"], m["feat_dim"]
    return Op("image_gather", 0, b * k * (f - 4) * BF16 + b * k * 16
              + b * 4 + b * k * f * BF16 + b * k * 16)


def forward_ops(m: dict, b: int, qsum: int) -> List[Op]:
    """Every operation of one forward over b rows."""
    k, h = m["n_obj"], m["hid_dim"]
    ops = [image_op(m, b)]
    ops += [Op(p.name, p.flops, p.x_bytes + p.w_bytes + p.y_bytes)
            for p in products(m, b, qsum)]
    ops += [Op("neighbour_selection", 0, b * k * k * F32 * 3),
            Op("pseudo_coordinates", 0, b * k * 16 + b * k * k * 2 * F32),
            Op("max_pool", 0, b * k * h * BF16 + b * h * F32)]
    return ops


def train_ops(m: dict, b: int, qsum: int) -> List[Op]:
    """Every operation of one training step over b rows: the forward
    from the device table, the loss, the backward (each needed gradient
    of each product one product of the forward's operations, reading and
    writing what it did), the embedding's gradient and Adam over every
    parameter (parameter, gradient and both moments read, parameter and
    moments written: 28 bytes a parameter)."""
    o = m["out_dim"]
    ops = forward_ops(m, b, qsum)
    ops.append(Op("loss", 0, 3 * b * o * F32))
    for p in products(m, b, qsum):
        moved = p.x_bytes + p.w_bytes + p.y_bytes
        for want, tag in ((p.dx, "dx"), (p.dw, "dw")):
            if want:
                ops.append(Op(f"{p.name}.{tag}", p.flops, moved))
    ops.append(Op("embedding_grad", 0, qsum * m["emb_dim"] * F32 * 2))
    ops.append(Op("adam", 0, 28 * n_params(m), "f32"))
    return ops


def model_flops(m: dict, b: int, qsum: int, train: bool) -> float:
    """The forward's product operations over b filled rows, three times
    that for a training step (forward, and the two products of the
    backward), with no recompute."""
    f = sum(p.flops for p in products(m, b, qsum))
    return 3 * f if train else f


def least_seconds(ops: Sequence[Op]) -> float:
    return sum(op.seconds() for op in ops)
