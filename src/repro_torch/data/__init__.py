"""Synthetic federated voice corpus (the LM token streams wait for the
port's LM training)."""

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
]
