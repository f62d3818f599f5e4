"""Plain PyTorch ops on channels-last (NDHWC) volumes."""
