"""Input pipelines of the port: MNIST, CIFAR-10, synthetic ImageNet, the
causal-LM token data and the sharded, seeded, prefetching batch
loader."""
