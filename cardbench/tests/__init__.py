"""CPU tests of the benchmark (the card's runs are ``run.py``'s)."""
