# A copy of rlaifv_tpu/evals/object_halbench.py, function for function and under the same
# names: the port keeps its own copy and imports nothing of the JAX package.
"""Object HalBench: CHAIR hallucination metrics with a GPT object extractor.

Rebuild of the judge (ref: eval/eval_gpt_obj_halbench.py:35-545). Same
pipeline: GPT-3.5 extracts visible objects per caption (prompt kept
verbatim — it defines the benchmark), words map to the 80 COCO classes via
the synonym table + double-word rules, ground truth comes from COCO
segmentation + caption annotations, metrics are CHAIRs / CHAIRi / recall.

The 300-image cardinality check (:686), 5 resp/image structure and the
hallucinated-words dump format are preserved so reference tooling reads
our outputs.
"""
from __future__ import annotations

import json
import os
import re
from collections import defaultdict
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence

from rlaifv_tpu_torch.evals.gpt_client import FAIL_SENTINEL, Chat
from rlaifv_tpu_torch.evals.text_utils import lemmatize, noun_phrases, tokenize

DATA_DIR = os.path.join(os.path.dirname(__file__), "data")

# Benchmark-defining prompt (ref :49-71) — verbatim.
OBJECT_EXTRACTION_PROMPT = """You are an expert in image objects extraction according to a question answer pair. We asked an examiner to answer a question about a picture.

[Start of Question]

<image> {question}

[End of Question]

[Start of Examiner's Answer]

{answer}

[End of Examiner's Answer]


Assume that the answer is correct, please identify all visible objects that are directly shown in the image. Please following the instructions in below:

1. You should only mention objects that are explicitly mentioned in the examiner's answer.
2. You should only extract the object names without the attributes of the objects.
3. You should not include the properties of the object, like the color, material, etc. as part of the object name in your result.
4. Make your answer precise. Present the results in a JSON list format: [\"object_1\", ..., \"object_n\"].
5. You should return an empty JSON list () if no visible objects can be found.
"""


def parse_object_list(content: str) -> List[str]:
    """Tolerant JSON-list parse (ref :35-46)."""
    content = content.strip()
    try:
        return json.loads(content)
    except json.JSONDecodeError:
        m = re.search(r"\[.*?\]", content, re.S)
        if m:
            try:
                return json.loads(m.group(0))
            except json.JSONDecodeError:
                pass
        try:
            return json.loads(content.strip().split("\n")[-1])
        except json.JSONDecodeError:
            raise ValueError("Content is not json interpretable")


class SynonymMapper:
    """COCO synonym + double-word mapping (ref :138-166)."""

    def __init__(self, synonyms_path: Optional[str] = None):
        path = synonyms_path or os.path.join(DATA_DIR, "synonyms_refine.txt")
        with open(path) as f:
            groups = [
                [w.strip() for w in line.strip().split(", ")]
                for line in f if line.strip()
            ]
        self.mscoco_objects: List[str] = []
        self.inverse_synonym: Dict[str, str] = {}
        for group in groups:
            self.mscoco_objects.extend(group)
            for word in group:
                self.inverse_synonym[word] = group[0]

        doubles = [w for w in self.inverse_synonym if len(w.split(" ")) >= 2]
        doubles += ["home plate", "train track"]
        self.double_word = {d: d for d in doubles}
        for animal in ("bird", "cat", "dog", "horse", "sheep", "cow",
                       "elephant", "bear", "zebra", "giraffe", "animal", "cub"):
            self.double_word[f"baby {animal}"] = animal
            self.double_word[f"adult {animal}"] = animal
        for vehicle in ("jet", "train"):
            self.double_word[f"passenger {vehicle}"] = vehicle
        self.double_word["bow tie"] = "tie"
        self.double_word["toilet seat"] = "toilet"
        self.double_word["wine glas"] = "wine glass"
        self._object_set = set(self.mscoco_objects)

    def merge_double_words(self, words: List[str], keep_singles: bool = True):
        out, i = [], 0
        while i < len(words):
            pair = " ".join(words[i : i + 2])
            if pair in self.double_word:
                out.append(self.double_word[pair])
                i += 2
            else:
                if keep_singles:
                    out.append(words[i])
                i += 1
        return out

    def caption_to_coco(self, caption: str):
        """caption text -> (coco words, [word, class] pairs) (ref :202-239)."""
        words = [lemmatize(w) for w in tokenize(caption.lower())]
        words = self.merge_double_words(words)
        if "toilet" in words and "seat" in words:
            words = [w for w in words if w != "seat"]
        kept = [w for w in words if w in self._object_set]
        node_words = [[w, self.inverse_synonym[w]] for w in kept]
        return kept, node_words, words

    def objects_to_coco(self, objs: List[str]):
        """pre-extracted object names -> coco pairs (ref :241-253)."""
        if "toilet" in objs and "seat" in objs:
            objs = [w for w in objs if w != "seat"]
        kept = [w for w in objs if w in self._object_set]
        return kept, [[w, self.inverse_synonym[w]] for w in kept]


def coco_gt_objects(coco_path: str, imids: Sequence[int],
                    mapper: SynonymMapper) -> Dict[int, set]:
    """GT object classes per image from segmentation + captions
    (ref :255-306)."""
    gt: Dict[int, set] = {imid: set() for imid in imids}

    with open(os.path.join(coco_path, "instances_val2014.json")) as f:
        segments = json.load(f)
    id_to_name = {c["id"]: c["name"] for c in segments["categories"]}
    for ann in segments["annotations"]:
        imid = ann["image_id"]
        if imid in gt:
            name = id_to_name[ann["category_id"]]
            node = mapper.inverse_synonym.get(name)
            if node:
                gt[imid].add(node)

    with open(os.path.join(coco_path, "captions_val2014.json")) as f:
        captions = json.load(f)
    for ann in captions["annotations"]:
        imid = ann["image_id"]
        if imid in gt:
            _, node_words, _ = mapper.caption_to_coco(ann["caption"])
            gt[imid].update(node for _, node in node_words)
    return gt


def extract_objects_gpt(
    caps: Sequence[dict], chat: Chat, max_workers: int = 64
):
    """Parallel GPT object extraction (ref :308-388)."""
    used, success = defaultdict(int), defaultdict(int)

    def one(item):
        prompt = OBJECT_EXTRACTION_PROMPT.format(
            question=item.get("question", ""), answer=item["caption"]
        )
        text, usage = chat.chat_completion(
            [{"role": "user", "content": prompt}], temperature=0
        )
        item = dict(item)
        if text == FAIL_SENTINEL:
            item["extract_objs"] = []
        else:
            try:
                item["extract_objs"] = [
                    str(o).lower() for o in parse_object_list(text)
                ]
            except ValueError:
                item["extract_objs"] = []
        for k, v in (usage or {}).items():
            if isinstance(v, int):
                used[k] += v
        return item

    with ThreadPoolExecutor(max_workers=max_workers) as pool:
        out = list(pool.map(one, caps))
    return out, dict(used), dict(success)


def refine_extracted_objects(caps: Sequence[dict], mapper: SynonymMapper):
    """Lemma + double-word + noun-phrase refinement of GPT object strings
    (ref get_pred_objs_match :406-435; POS tagging falls back offline)."""
    out = []
    for item in caps:
        refined: List[str] = []
        for text in item.get("extract_objs", []):
            toks = [lemmatize(t) for t in tokenize(f"a {text}")]
            doubles = mapper.merge_double_words(toks, keep_singles=False)
            if doubles:
                refined += doubles
                continue
            refined += noun_phrases(toks)
        item = dict(item)
        item["objs"] = list(dict.fromkeys(refined))
        out.append(item)
    return out


def compute_chair(
    caps: Sequence[dict],
    gt_objects: Dict[int, set],
    mapper: SynonymMapper,
    use_extracted: bool = False,
) -> dict:
    """CHAIRs / CHAIRi / recall over caption rows
    (ref :437-545; same output dict shape)."""
    num_caps = num_coco_caps = num_hallucinated = 0
    hallucinated_words = coco_words = gt_words = coco_cls = 0
    total_word_num = 0
    sentences = []

    for cap_eval in caps:
        cap = cap_eval["caption"]
        imid = cap_eval["image_id"]
        total_word_num += len(cap.strip().split(" "))

        if use_extracted:
            kept, node_words = mapper.objects_to_coco(cap_eval["objs"])
            raw_words = cap_eval["objs"]
        else:
            kept, node_words, raw_words = mapper.caption_to_coco(cap)

        gt = gt_objects[imid]
        gt_words += len(gt)
        cap_dict = {
            "image_id": imid,
            "caption": cap,
            "mscoco_hallucinated_words": [],
            "mscoco_gt_words": list(gt),
            "mscoco_generated_words": list(node_words),
            "hallucination_idxs": [],
            "words": raw_words,
            "metrics": {"CHAIRs": 0, "CHAIRi": 0},
        }

        coco_words += len(node_words)
        matched_cls = set()
        hallucinated = False
        for idx, (word, node) in enumerate(zip(kept, node_words)):
            if node[-1] not in gt:
                hallucinated_words += 1
                cap_dict["mscoco_hallucinated_words"].append((word, node))
                cap_dict["hallucination_idxs"].append(idx)
                hallucinated = True
            else:
                matched_cls.add(node[-1])
        coco_cls += len(matched_cls)

        num_caps += 1
        num_hallucinated += int(hallucinated)
        cap_dict["metrics"]["CHAIRs"] = int(hallucinated)
        if kept:
            num_coco_caps += 1
            cap_dict["metrics"]["CHAIRi"] = (
                len(cap_dict["mscoco_hallucinated_words"]) / float(len(kept))
            )
        sentences.append(cap_dict)

    chair_s = num_hallucinated / num_caps
    chair_s_refine = num_hallucinated / max(num_coco_caps, 1)
    chair_i = hallucinated_words / max(coco_words, 1)
    return {
        "sentences": sentences,
        "overall_metrics": {
            "CHAIRs": chair_s,
            "CHAIRs_refine": chair_s_refine,
            "CHAIRi": chair_i,
            "obj_rec": coco_cls / max(gt_words, 1),
            "sentence_num": num_caps,
            "coco_sentence_num": num_coco_caps,
            "coco_word_count": coco_cls,
            "gt_word_count": gt_words,
            "avg_word_len": total_word_num / num_caps,
            "correct_rate": 1 - chair_s_refine,
            "object_correct_rate": 1 - chair_i,
        },
    }


def evaluate(
    answers: Sequence[dict],
    coco_path: str,
    *,
    chat: Optional[Chat] = None,
    use_gpt: bool = True,
    expected_images: Optional[int] = 300,  # ref :686
) -> dict:
    """answers: rows with {'image_id', 'caption', 'question'}."""
    imids = {a["image_id"] for a in answers}
    if expected_images is not None:
        assert len(imids) == expected_images, (
            f"Object HalBench expects {expected_images} images, got {len(imids)}"
        )
    mapper = SynonymMapper()
    gt = coco_gt_objects(coco_path, sorted(imids), mapper)

    caps = list(answers)
    if use_gpt:
        chat = chat or Chat(model="gpt-3.5-turbo-0613")
        caps, used, _ = extract_objects_gpt(caps, chat)
        caps = refine_extracted_objects(caps, mapper)
    result = compute_chair(caps, gt, mapper, use_extracted=use_gpt)
    return result
