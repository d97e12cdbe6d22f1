"""Write any checkpoint as the reference's bare torch state_dict.

    python -m vqa_project_tpu_torch.cli.export_torch <checkpoint> <out.pt>

Counterpart of ``vqa_project_tpu/cli/export_torch.py``. The checkpoint
is any kind ``train.load_checkpoint`` reads: the port's own, a reference
``.pt`` or a JAX-package msgpack. The output is the state_dict of
``models/weights.py::export_reference_state_dict`` (float32, the
reference's names and shapes), which the reference's
``model.load_state_dict`` and the port's ``load_reference_checkpoint``
read unchanged.
"""

from __future__ import annotations

import argparse


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("checkpoint",
                    help="the port's .ckpt, a reference .pt or a JAX "
                         "msgpack checkpoint")
    ap.add_argument("out", help="output torch .pt path")
    args = ap.parse_args(argv)

    import torch

    from vqa_project_tpu_torch.models.weights import \
        export_reference_state_dict
    from vqa_project_tpu_torch.train.state import load_checkpoint

    payload = load_checkpoint(args.checkpoint)
    torch.save(export_reference_state_dict(payload["state_dict"]), args.out)
    print(f"wrote {args.out} (reference state_dict format)")


if __name__ == "__main__":
    main()
