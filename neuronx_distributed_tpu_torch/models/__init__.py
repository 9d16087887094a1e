"""Model families."""
