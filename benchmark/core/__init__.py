"""The harness: what every cell shares (reading the manifest and the
cell's files, the card, the traced window, the comparison, the result
line)."""
