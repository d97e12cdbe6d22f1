"""The operations and bytes that MCAN's work needs, from its shapes and
each batch's live rows.

Frozen arithmetic, the yardstick of ``mcan.products.roofline``,
``kernels.roofline.train`` and ``mfu.train`` in MCAN's cells: a change
to the program cannot move it. It counts what the inputs need, whatever
kernels do the work: every product over each image's live regions and
each question's live tokens only (padding rows are work the inputs do
not need), attention over live keys only; each product's operands in
bfloat16 and its parameters in float32, read once a forward, its result
in float32, or bfloat16 where the next product reads it (q, k, v, the
attention's output); the backward's products, one per gradient a step
needs (of the input, of the weight or second operand), reading and
writing what the forward's did. Elementwise arithmetic (LN, softmax,
masks, dropout, residuals) is left out, so the least time stays a lower
bound. Besides the products: the image gather (the table's rows in and
out), the loss, the embedding's gradient and Adam (28 bytes a
parameter).

``m`` is a configuration's model section (``portbench/configs``);
``live`` holds, for a batch of ``b`` questions, the sums of its live
token counts T (``t1``), of T^2 (``t2``), of its images' region counts R
(``r1``), of R^2 (``r2``) and of R T (``rt``).
"""

from __future__ import annotations

from typing import Dict, List

from portbench.counts.ops import BF16, F32, Op, Product


def live_sums(qlen, regions, b: int) -> Dict[str, float]:
    """The expected ``live`` of a batch of ``b`` questions drawn from a
    table whose questions have lengths ``qlen`` and images of
    ``regions`` regions (numpy arrays, one entry a question)."""
    t = qlen.astype("float64")
    r = regions.astype("float64")
    return {"t1": b * t.mean(), "t2": b * (t * t).mean(),
            "r1": b * r.mean(), "r2": b * (r * r).mean(),
            "rt": b * (r * t).mean()}


def products(m: dict, b: int, live: Dict[str, float]) -> List[Product]:
    """The forward's products."""
    h, ff, e = m["hidden_size"], m["ff_size"], m["word_embed_size"]
    f, heads = m["img_feat_size"], m["multi_head"]
    mlp, g, fo = m["flat_mlp_size"], m["flat_glimpses"], m["flat_out_size"]
    a, layers = m["answer_size"], m["layer"]
    t1, t2, r1, r2, rt = (live[k] for k in ("t1", "t2", "r1", "r2", "rt"))

    def lin(name, rows, cin, cout, dx=True, y=F32):
        return Product(name, 2 * rows * cin * cout, rows * cin * BF16,
                       cin * cout * F32, rows * cout * y, dx, True)

    def att(name, q_rows, k_rows, pairs):
        """scores over ``pairs`` (query, key) pairs of every head, and the
        probabilities times v"""
        return [
            Product(f"{name}.scores", 2 * pairs * h,
                    (q_rows + k_rows) * h * BF16, 0, pairs * heads * F32,
                    True, True),
            Product(f"{name}.pv", 2 * pairs * h,
                    pairs * heads * BF16 + k_rows * h * BF16, 0,
                    q_rows * h * BF16, True, True)]

    out = [lin("lstm_input", t1, e, 4 * h),
           lin("lstm_recurrence", t1, h, 4 * h),
           lin("img_feat_linear", r1, f, h, dx=False)]
    for i in range(layers):
        p = f"enc{i}"
        out += [lin(f"{p}.qkv", t1, h, 3 * h, y=BF16)]
        out += att(f"{p}.att", t1, t1, t2)
        out += [lin(f"{p}.merge", t1, h, h), lin(f"{p}.ffn1", t1, h, ff),
                lin(f"{p}.ffn2", t1, ff, h)]
    for i in range(layers):
        p = f"dec{i}"
        out += [lin(f"{p}.qkv", r1, h, 3 * h, y=BF16)]
        out += att(f"{p}.self", r1, r1, r2)
        out += [lin(f"{p}.merge1", r1, h, h),
                lin(f"{p}.guided_q", r1, h, h, y=BF16),
                lin(f"{p}.guided_kv", t1, h, 2 * h, y=BF16)]
        out += att(f"{p}.guided", r1, t1, rt)
        out += [lin(f"{p}.merge2", r1, h, h), lin(f"{p}.ffn1", r1, h, ff),
                lin(f"{p}.ffn2", r1, ff, h)]
    for name, rows in (("flat_lang", t1), ("flat_img", r1)):
        out += [lin(f"{name}.mlp1", rows, h, mlp),
                lin(f"{name}.mlp2", rows, mlp, g),
                lin(f"{name}.merge", b, h * g, fo)]
    out.append(lin("proj", b, fo, a))
    return out


def _backward(prods: List[Product]) -> List[Op]:
    ops = []
    for p in prods:
        moved = p.x_bytes + p.w_bytes + p.y_bytes
        for want, tag in ((p.dx, "dx"), (p.dw, "dw")):
            if want:
                ops.append(Op(f"{p.name}.{tag}", p.flops, moved))
    return ops


def product_ops(m: dict, b: int, live: Dict[str, float]) -> List[Op]:
    """Every product of a training step: the forward's and the
    backward's."""
    prods = products(m, b, live)
    return ([Op(p.name, p.flops, p.x_bytes + p.w_bytes + p.y_bytes)
             for p in prods] + _backward(prods))


def train_ops(m: dict, b: int, live: Dict[str, float],
              n_params: int) -> List[Op]:
    """Every operation of a training step over ``b`` questions:
    ``product_ops``, the image gather (B x K table rows of bfloat16 in
    and out, and their counts), the loss (logits, labels and the
    gradient), the embedding's gradient and Adam."""
    k, f, a = m["img_feat_pad_size"], m["img_feat_size"], m["answer_size"]
    return (product_ops(m, b, live)
            + [Op("image_gather", 0, 2 * b * k * f * BF16 + 2 * b * 4),
               Op("loss", 0, 3 * b * a * F32),
               Op("embedding_grad", 0,
                  live["t1"] * m["word_embed_size"] * F32 * 2),
               Op("adam", 0, 28 * n_params, "f32")])


def model_flops(m: dict, b: int, live: Dict[str, float]) -> float:
    """The product operations of a training step over the live rows."""
    return sum(op.flops for op in product_ops(m, b, live))


def least_seconds(ops: List[Op]) -> float:
    return sum(op.seconds() for op in ops)


def products_least_seconds(m: dict, b: int, live: Dict[str, float]) -> float:
    """The least time of a step's products at the published peaks."""
    return least_seconds(product_ops(m, b, live))

