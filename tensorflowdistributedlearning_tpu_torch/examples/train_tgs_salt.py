"""End-to-end TGS Salt training script of the port (counterpart of the JAX
package's ``examples/train_tgs_salt.py``): the reference's notebooks as a
script, against a Kaggle competition-data directory:

    data_root/
      train/images/*.png   train/masks/*.png
      test/images/*.png    (for --predict)
      train.csv            (optional manifest of the train ids)

    python -m tensorflowdistributedlearning_tpu_torch.examples.train_tgs_salt \\
        --data-root /path/to/tgs --model-dir /tmp/run \\
        [--batch-size 64] [--steps 10000] [--predict --submission sub.csv]

It builds the ids and the mask-coverage classes with
``load_tgs_training_set``, trains every fold with ``Trainer.train`` and
prints one JSON line (the folds' final eval metrics and ``n_params``);
``--predict`` then runs the fold × TTA ensemble over ``test/`` and
``--submission`` writes its Kaggle CSV. The defaults are the notebooks'
(batch 64, 10 000 steps, 5 folds). ``--device`` is the torch device (CUDA
unless the caller asks for another).
"""

from __future__ import annotations

import argparse
import json
import logging
import os
from typing import List, Optional

from tensorflowdistributedlearning_tpu_torch.config import TrainConfig
from tensorflowdistributedlearning_tpu_torch.data.kaggle import load_tgs_training_set, write_submission
from tensorflowdistributedlearning_tpu_torch.train.trainer import Trainer


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m tensorflowdistributedlearning_tpu_torch.examples.train_tgs_salt",
                                description="TGS Salt K-fold training, then optional ensemble prediction")
    p.add_argument("--data-root", required=True)
    p.add_argument("--model-dir", required=True)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--steps", type=int, default=10_000)
    p.add_argument("--n-fold", type=int, default=5)
    p.add_argument("--lr", type=float, default=0.001)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--predict", action="store_true", help="after training, run the fold x TTA ensemble on test/")
    p.add_argument("--submission", default=None, help="write a Kaggle submission csv here (implies --predict)")
    p.add_argument("--input-shape", type=int, nargs=2, default=(101, 101))
    p.add_argument("--n-blocks", type=int, nargs="+", default=(3, 4, 6))
    p.add_argument("--base-depth", type=int, default=256)
    p.add_argument("--device", default=None, help="torch device (default: cuda; no CPU fallback)")
    return p


def main(argv: Optional[List[str]] = None) -> int:
    logging.basicConfig(level=logging.INFO)
    args = build_parser().parse_args(argv)
    train_dir = os.path.join(args.data_root, "train")
    train_csv = os.path.join(args.data_root, "train.csv")
    ids, classes = load_tgs_training_set(train_dir, train_csv if os.path.exists(train_csv) else None)
    trainer = Trainer(
        args.model_dir,
        train_dir,
        train_config=TrainConfig(lr=args.lr, n_folds=args.n_fold, seed=args.seed),
        device=args.device,
        input_shape=tuple(args.input_shape),
        n_blocks=tuple(args.n_blocks),
        base_depth=args.base_depth,
    )
    results = trainer.train(ids, classes, batch_size=args.batch_size, steps=args.steps)
    print(json.dumps({"folds": results, "n_params": trainer.params}))
    if args.predict or args.submission:
        pred = trainer.predict(os.path.join(args.data_root, "test"), batch_size=args.batch_size, tta=True)
        if args.submission:
            write_submission(args.submission, pred["ids"], pred["masks"])
            print(json.dumps({"submission": args.submission, "n": len(pred["ids"])}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
