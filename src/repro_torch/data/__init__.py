"""Synthetic federated voice corpus and the LM token streams."""

from repro_torch.data.lm import MarkovTokens, token_batches
from repro_torch.data.voice import (
    CHAR_TO_ID,
    FEAT_DIM,
    FRAMES_PER_CHAR,
    VOCAB,
    VOCAB_SIZE,
    ClientShard,
    Utterance,
    batchify,
    encode_text,
    make_client_shard,
    make_eval_set,
    sample_command,
    synth_frames,
)

__all__ = [
    "CHAR_TO_ID",
    "FEAT_DIM",
    "FRAMES_PER_CHAR",
    "MarkovTokens",
    "VOCAB",
    "VOCAB_SIZE",
    "ClientShard",
    "Utterance",
    "batchify",
    "encode_text",
    "make_client_shard",
    "make_eval_set",
    "sample_command",
    "synth_frames",
    "token_batches",
]
