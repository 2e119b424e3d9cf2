"""``python -m fed_tgan_torch``: entry points of the port.

- ``python -m fed_tgan_torch serve ART [--port P] [--device cuda|cpu]
  [--workers N --max-batch B --coalesce-window S ...]``: one model over
  HTTP (:mod:`fed_tgan_torch.serve.service`);
- ``python -m fed_tgan_torch fleet NAME=DIR [NAME=DIR ...] [flags]``: many
  models behind one server (:mod:`fed_tgan_torch.serve.fleet`);
- ``python -m fed_tgan_torch sample-client --url URL --rows N [--chunks
  K]``: fetch rows from a running server;
- ``python -m fed_tgan_torch --sample-from ART --sample-rows N --seed S
  --out FILE [--device cuda|cpu]``
- ``python -m fed_tgan_torch --mode fedavg|standalone ...``: training
  (:mod:`fed_tgan_torch.cli`, the JAX CLI's flags).
"""

from __future__ import annotations

import argparse
import sys


def sample_main(argv=None) -> int:
    from fed_tgan_torch.serve.engine import SamplingEngine
    from fed_tgan_torch.serve.registry import ArtifactError, open_model

    ap = argparse.ArgumentParser(
        prog="python -m fed_tgan_torch",
        description="sample synthetic rows from a port artifact into a CSV "
                    "(`serve ART` starts the HTTP server instead)")
    ap.add_argument("--sample-from", required=True, metavar="DIR")
    ap.add_argument("--sample-rows", type=int, required=True)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", required=True, help="output CSV path")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--allow-meta-mismatch", action="store_true")
    args = ap.parse_args(argv)
    if args.sample_rows <= 0:
        ap.error(f"--sample-rows {args.sample_rows}: must be positive")
    try:
        model = open_model(args.sample_from, device=args.device,
                           allow_meta_mismatch=args.allow_meta_mismatch)
    except ArtifactError as exc:
        print(f"--sample-from: {exc}")
        return 2
    blob = SamplingEngine(model).sample_csv_bytes(args.sample_rows,
                                                  seed=args.seed)
    with open(args.out, "wb") as f:
        f.write(blob)
    print(f"wrote {args.sample_rows} rows to {args.out}")
    return 0


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0] == "serve":
        from fed_tgan_torch.serve.service import serve_main

        return serve_main(argv[1:])
    if argv and argv[0] == "fleet":
        from fed_tgan_torch.serve.fleet import fleet_main

        return fleet_main(argv[1:])
    if argv and argv[0] == "sample-client":
        from fed_tgan_torch.serve.service import client_main

        return client_main(argv[1:])
    if any(a == "--sample-from" or a.startswith("--sample-from=")
           for a in argv):
        return sample_main(argv)
    from fed_tgan_torch.cli import main as train_main

    return train_main(argv)


if __name__ == "__main__":
    sys.exit(main())
