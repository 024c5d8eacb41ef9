"""Synthetic AGQA-format worlds for end-to-end testing.

The reference repo ships no test suite and its datasets are not
redistributable, so this framework tests itself against *generated* worlds:
random spatio-temporal scene graphs in the AGQA/Charades node format, question
/program pairs instantiated from templates over those graphs, GloVe-format
word-embedding files, and video features *correlated with the graph* (each
frame's feature is the sum of embeddings of the classes visible in it), so
that models trained on the synthetic corpus can genuinely learn and tests can
assert learning happens. Answers are produced by the symbolic executor itself,
which keeps the corpus consistent by construction (the same validation the
reference applies at ``utils/agqa_lite.py:54-57``). The port's own copy of
``stair_tpu/testing/synthetic.py``: the same seed writes the same files byte
for byte.
"""

from __future__ import annotations

import hashlib
import json
import os
import pickle
import random

import numpy as np

from stair_tpu_torch.programs.scene_graph import SceneGraphExecutor

# ---------------------------------------------------------------------------
# A small Charades-like ontology
# ---------------------------------------------------------------------------

OBJECTS = [
    "dish", "blanket", "book", "towel", "cup", "pillow", "phone", "shoe",
    "broom", "sandwich", "laptop", "mirror",
]
VERBS = ["holding", "taking", "putting", "throwing", "washing", "opening"]
RELATIONS = ["touching", "behind", "in_front_of", "beneath", "carrying"]

FPS = 3


def build_vocab():
    """id2word / word2id over objects, relations, verbs and action phrases."""
    id2word, word2id = {}, {}

    def add(key, word):
        id2word[key] = word
        word2id[word] = key

    for i, obj in enumerate(OBJECTS):
        add("o%03d" % i, obj)
    for i, rel in enumerate(RELATIONS):
        add("r%03d" % i, rel)
    for i, verb in enumerate(VERBS):
        add("u%03d" % i, verb)
    k = 0
    for i, verb in enumerate(VERBS):
        for j, obj in enumerate(OBJECTS):
            add("c%03d" % k, "%s a %s" % (verb, obj))
            k += 1
    return id2word, word2id


def _frame_key(n: int) -> str:
    return "%06d" % n


def make_scene_graph(rng: random.Random, word2id, num_frames: int = 24):
    """One synthetic video's scene graph (frames start at 1)."""
    g = {}
    frames = list(range(1, num_frames + 1))
    for n in frames:
        g[_frame_key(n)] = {"secs": n / FPS}

    # 2-4 actions with non-degenerate intervals and distinct charades ids.
    phrases = set()
    actions = []
    n_actions = rng.randint(2, 4)
    while len(actions) < n_actions:
        verb = rng.choice(VERBS)
        obj = rng.choice(OBJECTS)
        phrase = "%s a %s" % (verb, obj)
        if phrase in phrases:
            continue
        phrases.add(phrase)
        start = rng.randint(1, num_frames - 4)
        end = rng.randint(start + 2, min(num_frames, start + rng.randint(3, 12)))
        cid = word2id[phrase]
        all_f = [_frame_key(n) for n in range(start, end + 1)]
        g["%s/%s" % (cid, all_f[0])] = {
            "charades": cid,
            "verb_id": word2id[verb],
            "object_id": word2id[obj],
            "phrase": phrase,
            "start": start,
            "end": end,
            "all_f": all_f,
        }
        actions.append((phrase, start, end))

    # Objects appear over contiguous frame runs.
    present_objects = rng.sample(OBJECTS, rng.randint(3, 6))
    for obj in present_objects:
        cid = word2id[obj]
        start = rng.randint(1, num_frames - 2)
        end = rng.randint(start, num_frames)
        for n in range(start, end + 1):
            g["%s/%s" % (cid, _frame_key(n))] = {"class": cid}

    # Relations link to 1-2 of the present objects per occurrence.
    for rel in rng.sample(RELATIONS, rng.randint(1, 3)):
        rid = word2id[rel]
        start = rng.randint(1, num_frames - 2)
        end = rng.randint(start, num_frames)
        linked = rng.sample(present_objects, rng.randint(1, min(2, len(present_objects))))
        for n in range(start, end + 1):
            g["%s/%s" % (rid, _frame_key(n))] = {
                "class": rid,
                "objects": [{"class": word2id[o]} for o in linked],
            }
    return g


# ---------------------------------------------------------------------------
# Question templates
# ---------------------------------------------------------------------------

def _sample_question(rng: random.Random, graph, id2word):
    """Instantiate one template against one scene graph.

    Returns ``(question, program, template_id, key_arg)`` — the latter two
    feed the generalization-split labels (novel_comp holds out specific
    template x argument compositions; more_steps marks the structurally
    deepest templates), mirroring the semantics of AGQA2's novel_comp /
    more_steps test splits (ref utils/agqa_lite.py:135-138).
    """
    actions = [graph[k]["phrase"] for k in graph if k.startswith("c")]
    objects = list({
        id2word[k.split("/")[0]] for k in graph if k.startswith("o")
    })
    relations = list({
        id2word[k.split("/")[0]]
        for k in graph
        if k.startswith("r") or k.startswith("v")
    })
    any_obj = rng.choice(OBJECTS)
    action = rng.choice(actions)
    template = rng.randrange(10)
    if template == 7:
        # Nested Exists under Xor: exercises the boolean supervision channel.
        obj2 = rng.choice([o for o in OBJECTS if o != any_obj])
        op = rng.choice(["XOR", "AND"])
        word = "exactly one" if op == "XOR" else "both"
        return (
            "were %s of a %s and a %s in the video ?" % (word, any_obj, obj2),
            "%s(Exists(%s, Iterate(video, Filter(frame, [objects]))), "
            "Exists(%s, Iterate(video, Filter(frame, [objects]))))"
            % (op, any_obj, obj2),
            7, any_obj,
        )
    if template == 8:
        # ToAction composes verb+object; exercises contrastive supervision.
        verb = rng.choice(VERBS)
        obj = rng.choice(OBJECTS)
        return (
            "was the person %s a %s at some point ?" % (verb, obj),
            "Exists(ToAction(%s, %s), Iterate(video, Filter(frame, [actions])))"
            % (verb, obj),
            8, verb,
        )
    if template == 9:
        # Equals over the first related object; exercises Equals supervision.
        rel = rng.choice(relations) if relations else "touching"
        rel_text = rel.replace("_", " ")
        return (
            "was a %s what they were %s first ?" % (any_obj, rel_text),
            "Equals(%s, Query(class, OnlyItem(IterateUntil(forward, video, "
            "Exists(%s, Filter(frame, [relations])), "
            "Filter(frame, [relations, %s, objects])))))"
            % (any_obj, rel_text, rel_text),
            9, any_obj,
        )
    if template == 0:
        return (
            "was a %s in the video ?" % any_obj,
            "Exists(%s, Iterate(video, Filter(frame, [objects])))" % any_obj,
            0, any_obj,
        )
    if template == 1:
        return (
            "was a %s there while %s ?" % (any_obj, action),
            "Exists(%s, Iterate(Localize(while, %s), Filter(frame, [objects])))"
            % (any_obj, action),
            1, any_obj,
        )
    if template == 2:
        mode = rng.choice(["before", "after"])
        return (
            "was a %s there %s %s ?" % (any_obj, mode, action),
            "Exists(%s, Iterate(Localize(%s, %s), Filter(frame, [objects])))"
            % (any_obj, mode, action),
            2, any_obj,
        )
    if template == 3:
        obj2 = rng.choice([o for o in OBJECTS if o != any_obj])
        return (
            "which was in the video , a %s or a %s ?" % (any_obj, obj2),
            "Choose(%s, %s, Iterate(video, Filter(frame, [objects])))"
            % (any_obj, obj2),
            3, any_obj,
        )
    if template == 4:
        mode = rng.choice(["max", "min"])
        word = "longest" if mode == "max" else "shortest"
        return (
            "what was the %s action in the video ?" % word,
            "Query(class, Superlative(%s, Filter(video, [actions]), "
            "Subtract(Query(end, action), Query(start, action))))" % mode,
            4, mode,
        )
    if template == 5:
        rel = rng.choice(relations) if relations else "touching"
        rel_text = rel.replace("_", " ")
        return (
            "what were they %s in the first frame where %s happened ?"
            % (rel_text, rel_text),
            "Query(class, OnlyItem(IterateUntil(forward, video, "
            "Exists(%s, Filter(frame, [relations])), "
            "Filter(frame, [relations, %s, objects]))))" % (rel_text, rel_text),
            5, rel_text,
        )
    # template == 6: Compare before/after
    return (
        "was a %s there before or after %s ?" % (any_obj, action),
        "Compare(Array2(before, after), Exists(%s, Iterate("
        "Localize(temporal_tag, %s), Filter(frame, [objects]))))"
        % (any_obj, action),
        6, any_obj,
    )


# ---------------------------------------------------------------------------
# Corpus generation
# ---------------------------------------------------------------------------

def make_world(
    out_dir: str,
    num_videos: int = 12,
    questions_per_video: int = 6,
    num_frames: int = 24,
    feature_dim: int = 64,
    glove_dim: int = 50,
    seed: int = 0,
):
    """Write a complete synthetic AGQA-format world under ``out_dir``.

    Produces: scene_graphs.pkl, ENG.json (id2word), IDX.json (word2id),
    questions.json (qa_id -> raw record), video_secs.json, glove.txt, and
    per-video feature .npy files under features/.
    Returns the paths dict.
    """
    rng = random.Random(seed)
    nprng = np.random.RandomState(seed)
    os.makedirs(out_dir, exist_ok=True)
    feat_dir = os.path.join(out_dir, "features")
    os.makedirs(feat_dir, exist_ok=True)

    id2word, word2id = build_vocab()
    graphs = {}
    video_secs = {}
    for v in range(num_videos):
        vid = "SYN%03d" % v
        graphs[vid] = make_scene_graph(rng, word2id, num_frames)
        video_secs[vid] = num_frames / FPS

    executor = SceneGraphExecutor(graphs, id2word, word2id)

    questions = {}
    qa_num = 0
    for vid in graphs:
        made = 0
        attempts = 0
        while made < questions_per_video and attempts < 50 * questions_per_video:
            attempts += 1
            question, program, tid, key_arg = _sample_question(
                rng, graphs[vid], id2word
            )
            try:
                answer, _steps, _meta = executor.run(video_id=vid, program=program)
            except Exception:
                continue
            if answer is None:
                continue
            # Generalization-split labels (AGQA2 semantics,
            # utils/agqa_lite.py:135-138): novel_comp marks deterministic
            # held-out template x argument compositions (a parity harness
            # keeps them out of train); more_steps marks the structurally
            # deepest programs (Compare doubling, Equals over IterateUntil).
            combo_hash = int(
                hashlib.md5(f"{tid}|{key_arg}".encode()).hexdigest()[:8], 16
            )
            questions["Q%05d" % qa_num] = {
                "question": question,
                "program": program,
                "answer": answer,
                "video_id": vid,
                "novel_comp": int(combo_hash % 7 == 0),
                "more_steps": int(tid in (6, 9)),
            }
            qa_num += 1
            made += 1

    # Class embeddings drive both the video features and the GloVe file, so
    # frame features genuinely encode which classes are visible.
    class_emb = {
        key: nprng.randn(feature_dim).astype(np.float32) * 0.5
        for key in id2word
    }
    # Video features sampled at 2x the final rate: the dataset loader
    # subsamples npy features with stride 2 (ref video_nmn/dataset.py:139).
    for vid, g in graphs.items():
        frames = sorted((k for k in g if k.startswith("0")), key=lambda k: k[-6:])
        feats = []
        for fkey in frames:
            vec = nprng.randn(feature_dim).astype(np.float32) * 0.05
            for key in g:
                if key.startswith("0"):
                    continue
                node = g[key]
                if key.startswith(("o", "r", "v")) and key.endswith("/" + fkey):
                    vec += class_emb[key.split("/")[0]]
                elif key.startswith("c") and node["all_f"][0] <= fkey <= node["all_f"][-1]:
                    vec += class_emb[node["charades"]]
            feats.append(vec)
            feats.append(vec + nprng.randn(feature_dim).astype(np.float32) * 0.05)
        np.save(os.path.join(feat_dir, vid + ".npy"), np.stack(feats))

    # GloVe-format embeddings for every word that can appear in questions.
    words = set()
    for rec in questions.values():
        words.update(rec["question"].split())
    for word in list(word2id) + OBJECTS + VERBS + RELATIONS:
        words.update(word.replace("_", " ").split())
    words.update(["the", "a", "an", "?", ",", "or"])
    glove_path = os.path.join(out_dir, "glove.txt")
    with open(glove_path, "w") as f:
        f.write("%d %d\n" % (len(words), glove_dim))
        for word in sorted(words):
            vec = nprng.randn(glove_dim) * 0.3
            f.write(word + " " + " ".join("%.5f" % x for x in vec) + "\n")

    paths = {
        "root": out_dir,
        "scene_graphs": os.path.join(out_dir, "scene_graphs.pkl"),
        "id2word": os.path.join(out_dir, "ENG.json"),
        "word2id": os.path.join(out_dir, "IDX.json"),
        "questions": os.path.join(out_dir, "questions.json"),
        "video_secs": os.path.join(out_dir, "video_secs.json"),
        "glove": glove_path,
        "features": feat_dir,
    }
    with open(paths["scene_graphs"], "wb") as f:
        pickle.dump(graphs, f)
    with open(paths["id2word"], "w") as f:
        json.dump(id2word, f)
    with open(paths["word2id"], "w") as f:
        json.dump(word2id, f)
    with open(paths["questions"], "w") as f:
        json.dump(questions, f)
    with open(paths["video_secs"], "w") as f:
        json.dump(video_secs, f)
    return paths
