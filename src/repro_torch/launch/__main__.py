"""``python -m repro_torch.launch [flags]``: the training driver
(:mod:`repro_torch.launch.train`)."""
from repro_torch.launch.train import main

if __name__ == "__main__":
    main()
