"""The assembled detector and its inference graphs."""
