"""The operations and bytes that Nemotron-H's work over region tokens
needs, from its shapes, each batch's live positions and the rows routed
to the held experts.

Frozen arithmetic, the yardstick of ``moe.expert_gemm.roofline``,
``kernels.roofline.train`` and ``mfu.train`` in its cell: a change to
the program cannot move it. It counts what the inputs need, whatever
kernels do the work, over each sequence's live positions only (its live
regions and tokens; padding is work the inputs do not need): every
product with its operands in bfloat16, its parameters in float32 read
once a forward and its result in float32 (bfloat16 where the next
product reads it); the scan as its chunked form's products over each
sequence's causal pairs (one chunk: no sequence is longer than 128), the
attention's scores and values over the causal pairs; the router's
product at the float32 peak; the experts over the held rows only. The
backward's products, one per gradient a step needs, read and write what
the forward's did. Elementwise arithmetic is left out, so the least time
stays a lower bound. Besides the products: the image gather, the loss,
the embedding's gradient and Adam (28 bytes a parameter).

``m`` is ``harness/nemotron.py::spec``'s dict; ``live`` is
``counts/mcan.py::live_sums``' (the batch's sums of tokens T, regions R
and their squares and product: a sequence is R + T long); ``held`` the
rows routed to the held experts a step in one MoE block.

``library_least_seconds`` is the least time of the products but the
held experts', which the library's kernels compute. ``expert_ops``
counts the grouped kernel's own products (the held
experts' forward, input and weight gradients) as that kernel sees them:
bf16 operands and weights, each expert's weights read once a product.
"""

from __future__ import annotations

from typing import Dict, List

from portbench.counts.ops import BF16, F32, Op, Product


def seq_sums(live: Dict[str, float]) -> Dict[str, float]:
    """(positions, causal pairs) of a batch: sum L and sum L (L + 1) / 2."""
    s1 = live["r1"] + live["t1"]
    s2 = live["r2"] + 2 * live["rt"] + live["t2"]
    return {"positions": s1, "pairs": 0.5 * (s2 + s1)}


def kinds(m: dict) -> str:
    return m["hybrid_override_pattern"][:m["num_hidden_layers"]]


def products(m: dict, b: int, live: Dict[str, float],
             held: float) -> List[Product]:
    """The forward's products."""
    h, f = m["hidden_size"], m["img_feat_size"]
    nh, hp = m["mamba_num_heads"], m["mamba_head_dim"]
    g, n = m["n_groups"], m["ssm_state_size"]
    inner = nh * hp
    q, kv, d = (m["num_attention_heads"], m["num_key_value_heads"],
                m["head_dim"])
    s = seq_sums(live)
    rows, pairs = s["positions"], s["pairs"]

    def lin(name, r, cin, cout, dx=True, y=F32):
        return Product(name, 2 * r * cin * cout, r * cin * BF16,
                       cin * cout * F32, r * cout * y, dx, True)

    out = [lin("projector1", live["r1"], f, h, dx=False),
           lin("projector2", live["r1"], h, h)]
    for i, kind in enumerate(kinds(m)):
        p = f"layer{i}"
        if kind == "M":
            out += [lin(f"{p}.in_proj", rows, h, 2 * inner + 2 * g * n + nh),
                    Product(f"{p}.ssd_cb", 2 * pairs * g * n,
                            2 * rows * g * n * BF16, 0, pairs * g * F32,
                            True, True),
                    Product(f"{p}.ssd_y", 2 * pairs * nh * hp,
                            pairs * nh * BF16 + rows * inner * BF16, 0,
                            rows * inner * F32, True, True),
                    lin(f"{p}.out_proj", rows, inner, h)]
        elif kind == "*":
            out += [lin(f"{p}.qkv", rows, h, (q + 2 * kv) * d, y=BF16),
                    Product(f"{p}.scores", 2 * pairs * q * d,
                            rows * (q + kv) * d * BF16, 0, pairs * q * F32,
                            True, True),
                    Product(f"{p}.pv", 2 * pairs * q * d,
                            pairs * q * BF16 + rows * kv * d * BF16, 0,
                            rows * q * d * BF16, True, True),
                    lin(f"{p}.o_proj", rows, q * d, h)]
        else:
            ie = m["moe_intermediate_size"]
            sh = m["moe_shared_expert_intermediate_size"]
            e = m["n_routed_experts"]
            out += [Product(f"{p}.router", 2 * rows * h * m["router_experts"],
                            rows * h * F32, m["router_experts"] * h * F32,
                            rows * m["router_experts"] * F32, True, True),
                    lin(f"{p}.shared_up", rows, h, sh, y=BF16),
                    lin(f"{p}.shared_down", rows, sh, h),
                    Product(f"{p}.experts_up", 2 * held * h * ie,
                            held * h * BF16, e * ie * h * F32,
                            held * ie * BF16, True, True),
                    Product(f"{p}.experts_down", 2 * held * ie * h,
                            held * ie * BF16, e * h * ie * F32,
                            held * h * F32, True, True)]
    out.append(lin("classifier", b, h, m["answer_size"]))
    return out


def _op(p: Product, flops: float, tag: str = "") -> Op:
    return Op(p.name + tag, flops, p.x_bytes + p.w_bytes + p.y_bytes,
              "f32" if p.name.endswith("router") else "bf16")


def product_ops(m: dict, b: int, live: Dict[str, float],
                held: float) -> List[Op]:
    """Every product of a training step: the forward's and the
    backward's."""
    ops = []
    for p in products(m, b, live, held):
        ops.append(_op(p, p.flops))
        for want, tag in ((p.dx, ".dx"), (p.dw, ".dw")):
            if want:
                ops.append(_op(p, p.flops, tag))
    return ops


def train_ops(m: dict, b: int, live: Dict[str, float], held: float,
              n_params: int) -> List[Op]:
    """``product_ops``, the image gather (B x K table rows of bfloat16 in
    and out), the loss (logits, labels and the gradient), the
    embedding's gradient and Adam."""
    k, f, a = m["img_feat_pad_size"], m["img_feat_size"], m["answer_size"]
    return (product_ops(m, b, live, held)
            + [Op("image_gather", 0, 2 * b * k * f * BF16 + 2 * b * 4),
               Op("loss", 0, 3 * b * a * F32),
               Op("embedding_grad", 0,
                  live["t1"] * m["hidden_size"] * F32 * 2),
               Op("adam", 0, 28 * n_params, "f32")])


def model_flops(m: dict, b: int, live: Dict[str, float],
                held: float) -> float:
    """The product operations of a training step over the live rows."""
    return sum(op.flops for op in product_ops(m, b, live, held))


def expert_ops(m: dict, held: float) -> List[Op]:
    """The grouped kernel's six products of one MoE block a step over
    ``held`` rows: x W_up^T (two bf16 outputs), a W_down^T (f32), dy
    W_down (bf16, reading the gate), dy^T a and dh^T x (f32 weight
    gradients of every held expert), dh W_up (f32)."""
    h, ie, e = m["hidden_size"], m["moe_intermediate_size"], \
        m["n_routed_experts"]
    fl = 2 * held * h * ie
    w = e * h * ie * BF16
    return [Op("up", fl, held * h * BF16 + w + 2 * held * ie * BF16),
            Op("down", fl, held * ie * BF16 + w + held * h * F32),
            Op("d_act", fl, held * h * BF16 + w + 2 * held * ie * BF16),
            Op("d_w_down", fl, held * (h + ie) * BF16 + e * h * ie * F32),
            Op("d_w_up", fl, held * (h + ie) * BF16 + e * h * ie * F32),
            Op("d_x", fl, held * ie * BF16 + w + held * h * F32)]


def library_least_seconds(m: dict, b: int, live: Dict[str, float],
                          held: float) -> float:
    """The least time of ``product_ops`` but the held experts' (the
    grouped kernel's, ``expert_ops``): the products the library
    computes."""
    return least_seconds([op for op in product_ops(m, b, live, held)
                          if ".experts_" not in op.name])


def least_seconds(ops: List[Op]) -> float:
    return sum(op.seconds() for op in ops)


def n_moe(m: dict) -> int:
    return kinds(m).count("E")
