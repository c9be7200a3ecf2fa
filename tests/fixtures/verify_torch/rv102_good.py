"""Fixture: keys and seeds threaded or confined to entry points (clean)."""
import torch

from repro_torch import random as prng


def from_seed(seed):
    return prng.PRNGKey(seed)


def main():
    torch.manual_seed(0)           # entry point: exempt
    return prng.PRNGKey(0)


if __name__ == "__main__":
    k = prng.PRNGKey(1)            # main guard: exempt
    main()
