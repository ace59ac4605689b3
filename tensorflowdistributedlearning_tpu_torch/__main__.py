"""Command line of the PyTorch port (counterpart of the JAX package's
``cli.py``; this slice carries ``serve`` and ``convert``).

    python -m tensorflowdistributedlearning_tpu_torch convert \\
        --params flax_vars.npz --config cfg.json --out ARTIFACT_DIR
    python -m tensorflowdistributedlearning_tpu_torch serve \\
        --artifact-dir ARTIFACT_DIR --port 8500 --buckets 1 4 16 64
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional


def cmd_convert(args) -> int:
    """Flax variables (.npz of ``params/...`` and ``batch_stats/...``) plus a
    ModelConfig JSON -> a serving artifact of the port."""
    import torch

    from tensorflowdistributedlearning_tpu_torch.config import ModelConfig
    from tensorflowdistributedlearning_tpu_torch.models.resnet import ResNetSegmentation
    from tensorflowdistributedlearning_tpu_torch.train.serving import export_serving_artifact
    from tensorflowdistributedlearning_tpu_torch.utils.convert import from_flax, load_flax_npz

    with open(args.config) as f:
        config = ModelConfig.from_json(f.read())
    params, stats = load_flax_npz(args.params)
    state = from_flax(params, stats, config)
    with torch.device("meta"):
        model = ResNetSegmentation(config)
    model.load_state_dict(state, strict=True, assign=True)
    path = export_serving_artifact(model, config, args.out, data_format=args.data_format)
    print(json.dumps({"artifact": args.out, "manifest": path, "tensors": len(state)}))
    return 0


def cmd_serve(args) -> int:
    """Serve an artifact over HTTP: warm every bucket, run the micro-batcher
    behind /v1/predict, drain on SIGINT/SIGTERM."""
    from tensorflowdistributedlearning_tpu_torch.serve import (
        InferenceEngine,
        MicroBatcher,
        ServingServer,
        bind_ephemeral,
    )

    engine = InferenceEngine.from_artifact(args.artifact_dir, device=args.device, buckets=args.buckets)
    warm = engine.warmup()
    batcher = MicroBatcher(engine, max_wait_ms=args.max_wait_ms, max_queue=args.queue_size)
    sock = bind_ephemeral(args.host, args.port)
    server = ServingServer(engine, batcher, sock=sock).start()
    server.install_signal_handlers()
    print(
        json.dumps(
            {
                "serving": server.url,
                "port": server.port,
                "buckets": list(engine.buckets),
                "warmup_s": {str(b): round(s, 6) for b, s in warm.items()},
            }
        ),
        flush=True,
    )
    server.wait()
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m tensorflowdistributedlearning_tpu_torch")
    sub = p.add_subparsers(dest="command", required=True)

    s = sub.add_parser("serve", help="serve an exported artifact over HTTP")
    s.add_argument("--artifact-dir", required=True)
    s.add_argument("--host", default="127.0.0.1")
    s.add_argument("--port", type=int, default=8500, help="0 picks a free port")
    s.add_argument("--buckets", type=int, nargs="+", default=[1, 4, 16, 64])
    s.add_argument("--max-wait-ms", type=float, default=5.0)
    s.add_argument("--queue-size", type=int, default=256)
    s.add_argument("--device", default=None, help="torch device; default cuda (no CPU fallback)")
    s.set_defaults(fn=cmd_serve)

    c = sub.add_parser("convert", help="flax variables .npz + config JSON -> serving artifact")
    c.add_argument("--params", required=True, help=".npz of flatten_dict({'params','batch_stats'}, sep='/')")
    c.add_argument("--config", required=True, help="ModelConfig as JSON")
    c.add_argument("--out", required=True, help="artifact directory to write")
    c.add_argument("--data-format", default="NHWC", choices=["NHWC", "NCHW"])
    c.set_defaults(fn=cmd_convert)
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
