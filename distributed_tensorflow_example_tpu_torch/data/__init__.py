"""Input pipelines of the port: MNIST, the causal-LM token data and the
sharded, seeded, prefetching batch loader."""
