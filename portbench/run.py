"""Run one cell of the port's benchmark once, and print its result.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Loads the cell (``portbench/harness/cell.py``), makes its inputs and
weights from the seed, warms up, measures for ``--seconds`` and checks
what the timed path produced against the plain reference
(``portbench/reference/``). The last line of standard output is one JSON
object: correct, attempted, failed, metrics (the cell's end-to-end
metrics with ``--trace 0``, its per-layer metrics with ``--trace 1``),
device, with ``--trace 1`` a breakdown, and last the numbers compared,
each with its limit; the same numbers end standard error.

Without a CUDA card, or with fewer cards than the cell asks for, it
exits with code 1 and prints no result; with jax, jaxlib, flax, optax or
the JAX package loaded once the window has closed, with code 4.

Two options serve the calibration of the limits and are never given by
the benchmark's own runs: ``--control fp8`` puts the control in the
program's place (the reference computed with fp8 operands);
``--fault <name>`` plants a fault in the timed path (``unchanged``,
``halfbatch``, ``answer``).
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import types  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "vqa_project_tpu")


def _caches(root: Path) -> None:
    """Every build and kernel cache of the program inside the checkout,
    at fixed paths (the kernels' own build goes to
    vqa_project_tpu_torch/_build/ there)."""
    base = root / ".portbench_cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(base / sub)
    os.environ["USE_FLAX"] = "0"


def loaded_forbidden() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def power_limit() -> str:
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def run(cell, seed: int, seconds: float, trace: bool, device, *,
        t0: float = None, control: str = None, fault: str = None,
        log=None) -> dict:
    """One run of ``cell`` on ``device``: the driver's result, with the
    per-layer metrics read (trace) and ``correct`` judged."""
    import torch
    from portbench.harness import checks, trace as tr
    log = log or (lambda *a: print(*a, file=sys.stderr, flush=True))
    tmp = os.environ.get("TMPDIR") or tempfile.gettempdir()
    ctx = types.SimpleNamespace(
        cell=cell, seed=int(seed), seconds=float(seconds), trace=bool(trace),
        device=torch.device(device), t0=T0 if t0 is None else t0,
        tmpdir=tmp, control=control, fault=fault, log=log)
    res = cell.driver().run(ctx)
    limits = cell.workload.get("limits", {})
    ok, compared = checks.judge(res["numbers"], limits)
    ok = ok and res["failed"] == 0 and res["attempted"] > 0
    metrics = {}
    if control is None and not trace:
        for m in cell.end_to_end:
            v = res["e2e"].get(m["name"])
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    if control is None and trace:
        for m in cell.per_layer:
            v = cell.reader(m["name"]).read(res["records"])
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    return {"correct": bool(ok), "attempted": res["attempted"],
            "failed": res["failed"], "metrics": metrics,
            "memory_peak_bytes": res.get("memory_peak_bytes", 0),
            "records": res.get("records"), "checks": compared,
            "breakdown": tr.breakdown(res.get("records"))}


def _plain(x):
    """A non-finite number as its name (strict JSON has none)."""
    return x if not isinstance(x, float) or math.isfinite(x) else repr(x)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", choices=("fp8",))
    p.add_argument("--fault", choices=("unchanged", "halfbatch", "answer"))
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    _caches(ROOT)
    from portbench.harness import cell as cellmod
    cell = cellmod.load(args.workload)
    import torch
    need = int(cell.entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"portbench: the cell needs {need} CUDA card(s); "
              f"available: {torch.cuda.is_available()}, "
              f"count: {torch.cuda.device_count()}", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    limit = power_limit()
    print(f"portbench: {args.workload} seed {args.seed} on {limit}",
          file=sys.stderr, flush=True)
    out = run(cell, args.seed, args.seconds, bool(args.trace), dev,
              control=args.control, fault=args.fault)
    bad = loaded_forbidden()
    if bad:
        print(f"portbench: modules of JAX or the JAX package loaded: {bad}",
              file=sys.stderr)
        return 4
    rec = out["records"] or {}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
              "count": need, "memory_peak_bytes": int(out["memory_peak_bytes"]),
              "power_limit": limit}
    if args.trace:
        device.update(busy_s=rec.get("busy_s", 0.0),
                      window_s=rec.get("window_s", 0.0))
    line = {"correct": out["correct"], "attempted": out["attempted"],
            "failed": out["failed"], "metrics": out["metrics"],
            "device": device}
    if args.trace and out["breakdown"]:
        line["breakdown"] = out["breakdown"]
    line["checks"] = {k: {"value": _plain(c["value"]), "limit": c["limit"]}
                      for k, c in out["checks"].items()}
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
