"""Device selection, weight conversion, config diff and image/array output."""
