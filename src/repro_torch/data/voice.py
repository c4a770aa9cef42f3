"""Synthetic federated voice-command corpus (stands in for Common Voice).

The paper filters Common Voice into four smart-assistant categories with
the Table II mixture (32.7 / 16.0 / 31.9 / 19.4 %). Offline we synthesise:

- **text**: per-category command templates with slot fillers (char-level
  tokens, vocab 64, id 0 = CTC blank / pad);
- **"audio" frames**: each character emits ``FRAMES_PER_CHAR`` frames of a
  character-specific random projection (fixed by a global seed — the
  "acoustic model" of the synthetic world) plus AWGN whose level comes
  from the client's operational context (bedroom vs kitchen etc., per
  Table I). A DeepSpeech2-style model genuinely has to learn the
  char→frame correspondence through CTC, and noisy-context clients
  genuinely have harder data — which is what makes contribution/precision
  planning matter.
- **client shards**: category mixtures from each simulated user's truth,
  shard size from their data-quantity factor (interaction frequency/time).
"""
from __future__ import annotations

import dataclasses
import random
from typing import Dict, List, Sequence

import numpy as np

from repro_torch.core.profiling.users import CATEGORIES, UserTruth

# char vocab: 0=blank/pad, 1=space, 2-27=a-z, 28='
VOCAB = ["<blank>", " "] + [chr(c) for c in range(ord("a"), ord("z") + 1)] + ["'"]
VOCAB_SIZE = 64  # padded to a round size (ids above 28 unused)
CHAR_TO_ID = {c: i for i, c in enumerate(VOCAB)}
# conv frontend downsamples 4x; 8 frames/char leaves T' = 2L after the
# convs, giving CTC the slack it needs for blanks between repeated chars.
FRAMES_PER_CHAR = 8
FEAT_DIM = 80

TEMPLATES: Dict[str, List[str]] = {
    "entertainment": [
        "play some {g} music", "put on my {g} playlist", "play the next song",
        "turn up the volume", "play {g} radio", "shuffle my {g} songs",
    ],
    "smart_home": [
        "turn off the {r} lights", "set the thermostat to twenty",
        "lock the front door", "dim the lights in the {r}",
        "turn on the {r} plug", "start the robot vacuum",
    ],
    "general_query": [
        "what is the weather today", "how far is the moon",
        "what time is it in tokyo", "who won the game last night",
        "how many ounces in a pound", "what is the news this morning",
    ],
    "personal_request": [
        "remind me to call mom", "add milk to my shopping list",
        "set an alarm for seven", "what is on my calendar today",
        "cancel my three o'clock meeting", "note that i parked on level two",
    ],
}
SLOTS = {
    "g": ["jazz", "rock", "pop", "classical", "folk", "blues"],
    "r": ["kitchen", "bedroom", "living room", "office", "hallway"],
}


def encode_text(text: str) -> np.ndarray:
    return np.array([CHAR_TO_ID[c] for c in text if c in CHAR_TO_ID],
                    np.int32)


def sample_command(rng: random.Random, category: str) -> str:
    t = rng.choice(TEMPLATES[category])
    for slot, fillers in SLOTS.items():
        t = t.replace("{" + slot + "}", rng.choice(fillers))
    return t


# fixed "acoustics": char id -> base feature vector
def _char_bank(seed: int = 1234) -> np.ndarray:
    rng = np.random.RandomState(seed)
    bank = rng.randn(VOCAB_SIZE, FEAT_DIM).astype(np.float32)
    return bank / np.linalg.norm(bank, axis=1, keepdims=True) * 3.0


CHAR_BANK = _char_bank()


def synth_frames(label_ids: np.ndarray, noise_level: float,
                 rng: np.random.RandomState) -> np.ndarray:
    """(len,) char ids -> (len*FRAMES_PER_CHAR, FEAT_DIM) noisy frames."""
    base = CHAR_BANK[label_ids]  # (L, F)
    frames = np.repeat(base, FRAMES_PER_CHAR, axis=0)
    # mild temporal smearing (coarticulation)
    if len(frames) > 2:
        frames[1:] = 0.85 * frames[1:] + 0.15 * frames[:-1]
    noise = rng.randn(*frames.shape).astype(np.float32)
    return frames + noise * (0.25 + 1.4 * noise_level)


@dataclasses.dataclass
class Utterance:
    text: str
    category: str
    label_ids: np.ndarray
    frames: np.ndarray


@dataclasses.dataclass
class ClientShard:
    user_id: int
    utterances: List[Utterance]

    def category_counts(self) -> Dict[str, int]:
        out = {c: 0 for c in CATEGORIES}
        for u in self.utterances:
            out[u.category] += 1
        return out


def make_client_shard(user: UserTruth, *, base_size: int = 24,
                      seed: int = 0) -> ClientShard:
    rng = random.Random(seed * 100003 + user.user_id)
    nrng = np.random.RandomState(seed * 7919 + user.user_id)
    n = max(4, int(base_size * (0.5 + user.data_quantity)))
    cats = list(user.category_mix.keys())
    probs = list(user.category_mix.values())
    utts = []
    for _ in range(n):
        cat = rng.choices(cats, probs)[0]
        text = sample_command(rng, cat)
        ids = encode_text(text)
        utts.append(Utterance(
            text=text, category=cat, label_ids=ids,
            frames=synth_frames(ids, user.noise_level, nrng)))
    return ClientShard(user.user_id, utts)


def make_eval_set(n: int = 120, *, noise_level: float = 0.3,
                  seed: int = 999) -> List[Utterance]:
    """Server-side balanced eval set (per-category accuracy for Fig. 4)."""
    rng = random.Random(seed)
    nrng = np.random.RandomState(seed)
    out = []
    per_cat = n // len(CATEGORIES)
    for cat in CATEGORIES:
        for _ in range(per_cat):
            text = sample_command(rng, cat)
            ids = encode_text(text)
            out.append(Utterance(text=text, category=cat, label_ids=ids,
                                 frames=synth_frames(ids, noise_level, nrng)))
    return out


def batchify(utts: Sequence[Utterance], max_frames: int = 0,
             max_labels: int = 0) -> Dict[str, np.ndarray]:
    """Pad a list of utterances into fixed arrays for the DS2 model."""
    B = len(utts)
    TF = max_frames or max(len(u.frames) for u in utts)
    TL = max_labels or max(len(u.label_ids) for u in utts)
    frames = np.zeros((B, TF, FEAT_DIM), np.float32)
    labels = np.zeros((B, TL), np.int32)
    frame_len = np.zeros((B,), np.int32)
    label_len = np.zeros((B,), np.int32)
    for i, u in enumerate(utts):
        f = u.frames[:TF]
        l = u.label_ids[:TL]
        frames[i, : len(f)] = f
        labels[i, : len(l)] = l
        frame_len[i] = len(f)
        label_len[i] = len(l)
    return {"frames": frames, "labels": labels,
            "frame_len": frame_len, "label_len": label_len}
