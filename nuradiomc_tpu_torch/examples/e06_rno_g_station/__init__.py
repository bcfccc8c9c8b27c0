"""examples/06_rno_g_station: the deep RNO-G phased array, the FLOWER
board, the surface trigger and the cleaning chain."""
