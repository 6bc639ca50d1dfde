"""Whisper-tiny — encoder-decoder ASR transformer [arXiv:2212.04356].

The mel-spectrogram + conv frontend is a STUB per the assignment carve-out:
``input_specs`` supplies 1500 precomputed frame embeddings (the output of
the two conv layers) and this config describes the transformer.
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="audio",
    num_layers=4,            # decoder layers
    d_model=384,
    num_heads=6,
    num_kv_heads=6,          # MHA
    d_ff=1536,
    vocab_size=51_865,
    is_encoder_decoder=True,
    num_encoder_layers=4,
    encoder_seq_len=1500,    # 30s audio -> 1500 frames after conv stride 2
    rope_theta=0.0,          # whisper uses learned/sinusoidal abs positions
    mlp_gelu=True,           # whisper FFNs are 2-matrix GELU
    tie_embeddings=True,
)
