"""`python -m kiwi_tpu_torch.native`: build the native codec library."""

if __name__ == "__main__":
    from . import build

    build(verbose=True)
