"""Input pipelines of the port: the causal-LM token data and the
sharded, seeded, prefetching batch loader."""
