"""Serving front-end: ``python -m vqa_project_tpu_torch.cli.serve``.

Loads a checkpoint and the dataset's artifacts and serves the
dynamic-batching ``InferenceServer`` over HTTP, on the card by default:

    python -m vqa_project_tpu_torch.cli.serve --model_path m.ckpt \\
        --data_dir ./data --port 8000
    curl -s localhost:8000/healthz
    curl -s -X POST localhost:8000/predict \\
        -d '{"question": "what color is the bus", "image_id": "123"}'

Counterpart of ``vqa_project_tpu/cli/serve.py`` with its flags and
defaults. ``--model_path`` is any checkpoint ``train.load_checkpoint``
reads: the port's own, a reference ``.pt`` or a JAX-package msgpack.
Without it the server runs random weights (the smoke mode); a path that
names no file raises. ``--quantize`` serves int8 projections
(``ModelConfig.quantized_inference``). ``--num_devices`` (JAX's default
1; 0 means every visible card) serves each padded batch split over that
many cards, one replica of the model on each
(``InferenceServer(devices=)``); a count above the visible cards
raises. Left out: the TPU-only ``--pallas`` / ``--no_pallas``. Added:
``--device`` (default ``cuda``; ``cpu`` runs the plain PyTorch versions
of the kernels).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

import torch


def input_args(argv=None):
    p = argparse.ArgumentParser(description="VQA inference server")
    p.add_argument("--model_path", type=str, required=False)
    p.add_argument("--data_dir", type=str, default="./data")
    p.add_argument("--split", type=str, default="val",
                   help="split whose FeatureStore serves image_id lookups")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--bsize", type=int, default=16)
    p.add_argument("--max_wait_ms", type=float, default=5.0)
    p.add_argument("--top_k", type=int, default=5)
    p.add_argument("--num_devices", type=int, default=1,
                   help="cards to serve one batch on (default 1: scale by "
                        "replica; >1 splits each padded batch over that "
                        "many cards, 0 = all)")
    # model hyper-params must match the checkpoint (same flags as run.py)
    p.add_argument("--emb", type=int, default=300)
    p.add_argument("--hid", type=int, default=1024)
    p.add_argument("--n_kernels", type=int, default=8)
    p.add_argument("--neighbourhood_size", type=int, default=16)
    p.add_argument("--n_obj", type=int, default=36)
    p.add_argument("--dropout", type=float, default=0.5)
    p.add_argument("--compute_dtype", type=str, default="bfloat16")
    p.add_argument("--quantize", action="store_true",
                   help="int8 projection weights and int8 products in "
                        "both graph convolutions and the weight-norm "
                        "layers (ops/quant.py)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (cpu runs the plain PyTorch "
                        "versions of the kernels)")
    from vqa_project_tpu_torch.cli.run import add_synthetic_args

    add_synthetic_args(p)
    return p.parse_args(argv)


def build_server(args):
    """The InferenceServer of ``args`` (split out for tests)."""
    from vqa_project_tpu_torch.cli.run import _dataset
    from vqa_project_tpu_torch.config import ModelConfig
    from vqa_project_tpu_torch.ops.quant import \
        quantize_state_dict_for_serving
    from vqa_project_tpu_torch.serve import InferenceServer
    from vqa_project_tpu_torch.train.loop import build_model
    from vqa_project_tpu_torch.train.state import load_checkpoint

    ds = _dataset(args, args.split)
    mcfg = ModelConfig(
        emb_dim=args.emb, hid_dim=args.hid, n_kernels=args.n_kernels,
        neighbourhood_size=args.neighbourhood_size, n_obj=args.n_obj,
        dropout=args.dropout, compute_dtype=args.compute_dtype)
    model = build_model(mcfg, ds, device=args.device, seed=0)
    if args.model_path:
        if not os.path.isfile(args.model_path):
            raise FileNotFoundError(f"--model_path {args.model_path} is "
                                    "not a file")
        load_checkpoint(args.model_path, model)
        print(f"Loaded {args.model_path}", flush=True)
    else:
        print("No --model_path; serving RANDOM weights (smoke mode)",
              file=sys.stderr)
    if args.quantize:
        float_sd = model.state_dict()
        model = build_model(
            dataclasses.replace(mcfg, quantized_inference=True), ds,
            device=args.device)
        model.load_state_dict(quantize_state_dict_for_serving(float_sd))
        print("int8 projection weights (serving quantization) on",
              flush=True)
    return InferenceServer(model, ds, devices=serving_devices(args),
                           batch_size=args.bsize,
                           max_wait_ms=args.max_wait_ms, top_k=args.top_k)


def serving_devices(args) -> list:
    """``--device`` once, or with ``--num_devices`` N != 1 cards 0..N-1
    (0: every visible card); more cards than visible raise. On the CPU,
    N replicas on the CPU."""
    n = args.num_devices
    if n == 1:
        return [args.device]
    if torch.device(args.device).type != "cuda":
        return [args.device] * max(n, 1)
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    n = cards if n == 0 else n
    if n > cards or n < 1:
        raise ValueError(f"requested {n} serving cards but only {cards} "
                         "CUDA device(s) are visible")
    return [f"cuda:{i}" for i in range(n)]


def main(argv=None):
    from vqa_project_tpu_torch.serve import make_http_server

    args = input_args(argv)
    server = build_server(args)
    httpd = make_http_server(server, args.port, args.host)
    host, port = httpd.server_address[:2]
    print(f"serving on http://{host}:{port} "
          f"(batch {server.batch_size}, wait {server.max_wait_ms} ms)",
          flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
        server.close()


if __name__ == "__main__":
    main()
