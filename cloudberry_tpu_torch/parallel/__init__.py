"""The segment layout and the motion transport of one card."""
