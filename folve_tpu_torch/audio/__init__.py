"""Audio file reading for the filter loader."""
