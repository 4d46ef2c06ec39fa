"""Dataset and end-to-end tools of the port (≙ the repository's tools/)."""
