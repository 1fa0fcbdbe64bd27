"""Input generators: every graph and stream comes from ``--seed`` alone."""
