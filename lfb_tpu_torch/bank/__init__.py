"""Long-term feature bank: construction and the device-resident bank."""
