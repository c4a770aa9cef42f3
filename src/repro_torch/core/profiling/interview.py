"""The LLM interview agent — SimLLM edition.

The paper drives profiling through an LLM-powered chat interface
(§III-A "User Profiling Frontend", §III-B "hybrid conversational
interface"). Offline we replace the hosted LLM with a deterministic
semantic parser over a synonym lexicon, exercised against *templated
utterances generated from each user's hidden ground truth plus noise*:

    ground truth --(templating + chattiness dropout)--> transcript
    transcript  --(SimLLM parse)--> InferredProfile

The interface (``InterviewAgent.interview``) is exactly what an
API-backed agent would implement — swap ``SimLLM`` for a real model and
nothing upstream changes. Crucially the parser is *imperfect on purpose*:
users may not mention factors (chattiness), wordings are ambiguous, and
the resulting inferred profile carries per-field confidence — the RAG
retrieval (§III-B2) exists to fill exactly these gaps.
"""

from __future__ import annotations

import dataclasses
import random
from typing import Dict, List, Optional, Tuple

from repro_torch.core.profiling.users import FACTORS, UserTruth

# ---------------------------------------------------------------------------
# utterance templates (generation side)
# ---------------------------------------------------------------------------

LOCATION_PHRASES = {
    "bedroom": ["it's in my bedroom", "sits on my nightstand", "bedroom device"],
    "living_room": [
        "it's in the living room",
        "next to the TV",
        "the kids use it in the lounge",
    ],
    "kitchen": ["kitchen counter", "I use it while cooking", "it's in the kitchen"],
    "office": ["on my office desk", "I use it at work", "study room"],
    "outdoor": ["I mostly use it outside", "on the patio", "in the garden"],
}
TIME_PHRASES = {
    "daytime": ["mostly during the day", "throughout the workday", "daytime mostly"],
    "nighttime": ["usually at night", "before bed", "late evenings"],
}
FREQ_PHRASES = {
    "low": ["only now and then", "a couple times a week", "rarely"],
    "medium": ["a few times a day", "pretty regularly", "daily"],
    "high": ["all the time", "constantly", "dozens of times a day"],
}
SENSITIVITY_PHRASES = {
    "accuracy": [
        "it keeps mishearing me",
        "I need it to get things right",
        "transcription mistakes drive me crazy",
        "accuracy matters most to me",
    ],
    "energy": [
        "the battery dies fast",
        "I worry about power usage",
        "it should be efficient",
        "battery life is my main concern",
    ],
    "latency": [
        "it feels sluggish",
        "I hate waiting for responses",
        "it must respond instantly",
        "speed is everything",
    ],
}
CATEGORY_PHRASES = {
    "entertainment": ["I mostly play music", "podcasts and radio"],
    "smart_home": [
        "controlling the lights",
        "smart home stuff",
        "thermostat and plugs",
    ],
    "general_query": ["asking questions", "weather and news"],
    "personal_request": ["reminders and my calendar", "personal lists"],
}

# ---------------------------------------------------------------------------
# lexicon (parsing side) — keyword -> (field, value, strength)
# ---------------------------------------------------------------------------

# keyword anchors are curated (not auto-split from the templates, so the
# parser genuinely has to generalise across phrasings):
LEXICON: List[Tuple[str, str, str, float]] = [
    ("bedroom", "location", "bedroom", 1.0),
    ("nightstand", "location", "bedroom", 0.9),
    ("living", "location", "living_room", 1.0),
    ("lounge", "location", "living_room", 0.9),
    ("tv", "location", "living_room", 0.6),
    ("kitchen", "location", "kitchen", 1.0),
    ("cooking", "location", "kitchen", 0.8),
    ("office", "location", "office", 1.0),
    ("desk", "location", "office", 0.7),
    ("work", "location", "office", 0.5),
    ("study", "location", "office", 0.8),
    ("outside", "location", "outdoor", 0.9),
    ("patio", "location", "outdoor", 0.9),
    ("garden", "location", "outdoor", 0.9),
    ("day", "time", "daytime", 0.7),
    ("workday", "time", "daytime", 0.9),
    ("night", "time", "nighttime", 0.9),
    ("bed", "time", "nighttime", 0.6),
    ("evenings", "time", "nighttime", 0.9),
    ("rarely", "frequency", "low", 1.0),
    ("now and then", "frequency", "low", 0.9),
    ("couple times a week", "frequency", "low", 1.0),
    ("regularly", "frequency", "medium", 0.8),
    ("few times a day", "frequency", "medium", 1.0),
    ("daily", "frequency", "medium", 0.7),
    ("all the time", "frequency", "high", 1.0),
    ("constantly", "frequency", "high", 1.0),
    ("dozens", "frequency", "high", 1.0),
    ("mishearing", "sens_accuracy", "", 1.0),
    ("get things right", "sens_accuracy", "", 0.9),
    ("mistakes", "sens_accuracy", "", 0.8),
    ("accuracy", "sens_accuracy", "", 1.0),
    ("battery", "sens_energy", "", 1.0),
    ("power usage", "sens_energy", "", 0.9),
    ("efficient", "sens_energy", "", 0.8),
    ("sluggish", "sens_latency", "", 0.9),
    ("waiting", "sens_latency", "", 0.8),
    ("instantly", "sens_latency", "", 1.0),
    ("speed", "sens_latency", "", 0.9),
    ("music", "cat_entertainment", "", 0.9),
    ("podcasts", "cat_entertainment", "", 0.9),
    ("radio", "cat_entertainment", "", 0.8),
    ("lights", "cat_smart_home", "", 0.9),
    ("smart home", "cat_smart_home", "", 1.0),
    ("thermostat", "cat_smart_home", "", 0.9),
    ("plugs", "cat_smart_home", "", 0.8),
    ("questions", "cat_general_query", "", 0.8),
    ("weather", "cat_general_query", "", 0.9),
    ("news", "cat_general_query", "", 0.8),
    ("reminders", "cat_personal_request", "", 0.9),
    ("calendar", "cat_personal_request", "", 0.9),
    ("lists", "cat_personal_request", "", 0.7),
]


@dataclasses.dataclass
class InferredProfile:
    """What the backend believes about a user after an interview."""

    user_id: int
    location: Optional[str] = None
    location_conf: float = 0.0
    time: Optional[str] = None
    time_conf: float = 0.0
    frequency: Optional[str] = None
    frequency_conf: float = 0.0
    # relative sensitivity signal strengths (unnormalised)
    sens: Dict[str, float] = dataclasses.field(
        default_factory=lambda: {f: 0.0 for f in FACTORS}
    )
    category_signal: Dict[str, float] = dataclasses.field(default_factory=dict)

    def weights_estimate(self) -> Dict[str, float]:
        """Normalised sensitivity estimate; uniform prior when silent."""
        base = {f: 0.34 + self.sens.get(f, 0.0) for f in FACTORS}
        s = sum(base.values())
        return {f: v / s for f, v in base.items()}

    def features(self) -> Dict[str, float]:
        f: Dict[str, float] = {}
        if self.location:
            f["loc_" + self.location] = self.location_conf
        if self.time:
            f["time_" + self.time] = self.time_conf
        if self.frequency:
            f["freq_" + self.frequency] = self.frequency_conf
        for c, v in self.category_signal.items():
            f["cat_" + c] = v
        for fac, v in self.sens.items():
            if v > 0:
                f["sens_" + fac] = v
        return f


class SimLLM:
    """Deterministic stand-in for the hosted LLM: parse(transcript)->fields.

    A production deployment implements the same two methods with an actual
    chat model; the pipeline is agnostic (DESIGN.md §2).
    """

    def parse(self, transcript: str) -> InferredProfile:
        text = transcript.lower()
        prof = InferredProfile(user_id=-1)
        best: Dict[str, Tuple[str, float]] = {}
        for kw, field, value, strength in LEXICON:
            if kw in text:
                if field.startswith("sens_"):
                    fac = field[5:]
                    prof.sens[fac] = max(prof.sens[fac], strength)
                elif field.startswith("cat_"):
                    cat = field[4:]
                    prof.category_signal[cat] = max(
                        prof.category_signal.get(cat, 0.0), strength
                    )
                else:
                    cur = best.get(field)
                    if cur is None or strength > cur[1]:
                        best[field] = (value, strength)
        if "location" in best:
            prof.location, prof.location_conf = best["location"]
        if "time" in best:
            prof.time, prof.time_conf = best["time"]
        if "frequency" in best:
            prof.frequency, prof.frequency_conf = best["frequency"]
        return prof


class InterviewAgent:
    """Generates the (simulated) conversation and parses it.

    Three interview triggers per the paper §III-A: device initialisation,
    pre-aggregation feedback, and hardware-change updates. All flow
    through the same generate+parse path here.
    """

    def __init__(self, seed: int = 0):
        self.rng = random.Random(seed + 99)
        self.llm = SimLLM()

    def _utterance(self, user: UserTruth) -> str:
        rng = self.rng
        parts: List[str] = []

        def reveal():
            return rng.random() < user.chattiness

        if reveal():
            parts.append(rng.choice(LOCATION_PHRASES[user.location]))
        if reveal():
            parts.append(rng.choice(TIME_PHRASES[user.interaction_time]))
        if reveal():
            parts.append(rng.choice(FREQ_PHRASES[user.frequency]))
        # sensitivities mentioned proportionally to true weight
        for fac in FACTORS:
            if rng.random() < user.weights[fac] * 1.4 * user.chattiness:
                parts.append(rng.choice(SENSITIVITY_PHRASES[fac]))
        # mention dominant categories
        for cat, p in user.category_mix.items():
            if rng.random() < p * 1.2 * user.chattiness:
                parts.append(rng.choice(CATEGORY_PHRASES[cat]))
        if not parts:
            parts.append("it's fine I guess")
        return ". ".join(parts) + "."

    def interview(self, user: UserTruth) -> Tuple[str, InferredProfile]:
        transcript = self._utterance(user)
        prof = self.llm.parse(transcript)
        prof.user_id = user.user_id
        return transcript, prof

    def feedback_utterance(self, user: UserTruth, satisfaction: float) -> str:
        """Post-round feedback text, tone keyed to realised satisfaction."""
        rng = self.rng
        if satisfaction > 0.35:
            base = rng.choice(["works great", "very happy with it", "no complaints"])
        elif satisfaction > 0.1:
            base = rng.choice(["it's okay", "decent overall", "fine mostly"])
        else:
            dominant = max(user.weights, key=user.weights.get)
            base = rng.choice(SENSITIVITY_PHRASES[dominant])
        return base + "."
