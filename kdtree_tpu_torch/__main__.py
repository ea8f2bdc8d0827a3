"""``python -m kdtree_tpu_torch ...`` runs the port's CLI."""

from kdtree_tpu_torch.utils.cli import main

if __name__ == "__main__":
    main()
