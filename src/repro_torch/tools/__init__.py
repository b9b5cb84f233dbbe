"""One-off measurements of the port on the card, run as scripts."""
