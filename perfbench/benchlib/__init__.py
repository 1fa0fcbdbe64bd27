"""The harness: manifest, traffic loops, device trace, statistics and checks."""
