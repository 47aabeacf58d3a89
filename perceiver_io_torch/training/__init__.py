"""Training: losses, optimizer, train state, step builders, trainer."""
