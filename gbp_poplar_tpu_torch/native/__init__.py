"""Native (C++) host components, bound with ctypes.

Currently the BAL parser (``balio_native``), built with the system g++ on
first use; utils/balio.load_bal falls back to its NumPy parser where the
native one cannot be built or refuses a file."""
