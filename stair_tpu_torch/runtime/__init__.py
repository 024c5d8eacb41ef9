"""Native host runtime: C++ gather/tokenize/parse libraries and their loader."""
