"""The dist runtime's pieces the port has so far: the consistent-hash ring
(:mod:`.ring`) that routes decode sessions stickily."""
