"""Entry points of the port that stand beside the trainer's CLI."""
