"""Model forwards of the port: dense, MLA, MoE, RWKV-6, encoder and cross-attention decoders."""
