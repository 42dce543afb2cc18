"""One rank of tests/test_torch_distributed.py's two-process run (gloo on
localhost, torchrun's environment variables).

    MASTER_ADDR=127.0.0.1 MASTER_PORT=<port> WORLD_SIZE=2 RANK=<r> \
        python tests/torch_two_process_worker.py <out_dir>

Initialises from the environment, gathers ragged objects, meets at a
barrier, runs assert_consistent on agreeing and on diverging values, runs
the reference-logp precompute of the tiny model on the shared rows (batch
pairs 1 and 8), and trains the tiny model 2 steps over the two processes
(DPOTrainer on the config's mesh: fsdp 2); writes what it saw to
<out_dir>/rank<r>.json.
"""
import json
import os
import sys
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from rlaifv_tpu_torch.core import distributed as dist  # noqa: E402


def raw_rows(rng, n, img_size):
    """RLAIF-V parquet rows (tests/test_torch_ref_logp.py's): question,
    chosen, rejected, PNG image bytes."""
    import io

    from PIL import Image

    def png():
        buf = io.BytesIO()
        Image.fromarray(rng.integers(0, 255, (img_size, img_size, 3), dtype=np.uint8)).save(
            buf, format="PNG")
        return buf.getvalue()

    return [{"idx": str(i), "question": f"What is in image {i}?",
             "chosen": f"A small {i} cat.", "rejected": f"A big {i} dog and a hat.",
             "image": {"bytes": png(), "path": f"img{i}.png"},
             "image_path": f"img{i}.png", "origin_dataset": "unit",
             "origin_split": "{}"} for i in range(n)]


def tiny_setup():
    """The tiny LLaVA (seed 0) and 5 rows, as the test's own process builds
    them for the one-process reference."""
    from rlaifv_tpu_torch.data.image_processing import ClipImageProcessor
    from rlaifv_tpu_torch.models.llava import LlavaConfig, LlavaForCausalLM, init_weights_
    from tests.fake_tokenizer import FakeTokenizer

    torch.manual_seed(0)
    cfg = LlavaConfig.tiny()
    model = init_weights_(LlavaForCausalLM(cfg), torch.Generator().manual_seed(0)).eval()
    rows = raw_rows(np.random.default_rng(11), 5, cfg.vision.image_size)
    kw = dict(max_len=320, num_patches=cfg.num_image_tokens,
              image_processor=ClipImageProcessor(image_size=cfg.vision.image_size))
    return model, FakeTokenizer(), rows, kw


def train_tiny(model, output_dir: str) -> int:
    """DPOTrainer on the config's default mesh (dp 1, fsdp null = every
    process, tp 1): 2 steps over 4 synthetic pairs, 2 pairs a process at
    world 2 (the test runs it at world 1 with per_device_batch_pairs 2 x
    world_size); -> the micro-steps taken. Process 0 writes metrics.jsonl."""
    from rlaifv_tpu_torch.core.config import Config
    from rlaifv_tpu_torch.data.collator import DPOCollator
    from rlaifv_tpu_torch.train.trainer import DPOTrainer
    from rlaifv_tpu_torch.utils.synth import synth_preference_pairs

    config = Config()
    t = config.training
    t.output_dir, t.max_steps, t.learning_rate = output_dir, 2, 1e-3
    t.per_device_batch_pairs = 4 // dist.process_count()
    cfg = model.cfg
    return DPOTrainer(config, model, synth_preference_pairs(cfg, 4, answer_len=6, question_len=4),
                      DPOCollator(pad_token_id=0, max_len=64,
                                  num_patches=cfg.num_image_tokens)).train()


def main(out_dir: str) -> None:
    dist.initialize()
    rank = dist.process_index()
    res = {"rank": rank, "count": dist.process_count(), "primary": dist.is_primary(),
           "backend": torch.distributed.get_backend()}
    obj = {"rank": rank, "data": list(range(3 * rank + 1)), "text": "x" * (1000 * (rank + 1))}
    res["gathered"] = dist.all_gather_objects(obj)
    dist.barrier("after gather")
    dist.assert_consistent({"seed": 1, "lr": 1e-3}, "agreeing")
    try:
        dist.assert_consistent({"seed": rank}, "diverging")
        res["diverging"] = None
    except AssertionError as e:
        res["diverging"] = str(e)

    from rlaifv_tpu_torch.train.ref_logp import inference_logp

    model, tok, rows, kw = tiny_setup()
    for bp in (1, 8):
        inference_logp(rows, model, tok, os.path.join(out_dir, f"world2_b{bp}"),
                       batch_pairs=bp, **kw)
    res["wrote"] = {bp: sorted(os.listdir(os.path.join(out_dir, f"world2_b{bp}")))
                    for bp in (1, 8)}

    from rlaifv_tpu_torch.core.config import Config
    from rlaifv_tpu_torch.data.collator import DPOCollator
    from rlaifv_tpu_torch.train.trainer import DPOTrainer
    from rlaifv_tpu_torch.utils.synth import synth_preference_pairs

    res["trainer"] = train_tiny(model, os.path.join(out_dir, "train"))
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    try:
        main(sys.argv[1])
    except Exception:
        traceback.print_exc()
        sys.exit(1)
