"""Host helpers: uids, text cleaning, the device seam."""
