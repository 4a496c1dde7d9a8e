"""Command-line tools of the port (``keraslm-rate``)."""
