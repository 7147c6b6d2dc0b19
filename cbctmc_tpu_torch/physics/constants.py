"""Physical and engine constants.

Values match the PENELOPE-2006 constants used by the reference engine
(reference: docker/mcgpu/MC-GPU_v1.3.h:59-92) so that simulated physics is
bit-comparable where float precision allows.
"""

# Electron rest energy [eV] (PENELOPE 2006 value).
ELECTRON_REST_ENERGY_EV = 510998.918

# 1 / electron rest energy [1/eV]
INV_ELECTRON_REST_ENERGY = 1.956951306108245e-6

# 2 * 20.6074 / ELECTRON_REST_ENERGY_EV: conversion from photon energy to the
# maximum momentum-transfer variable x = 20.6074 * 2E/m_e c^2 * sin(theta/2)
# used by Rayleigh form-factor sampling (reference: MC-GPU_kernel_v1.3.cu:1184).
RAYLEIGH_X_FACTOR = 8.065535669099010e-5

# Geometric epsilon [cm] used to keep particles strictly inside the voxel
# bounding box (reference: MC-GPU_v1.3.h "EPS_SOURCE").
EPS_SOURCE = 1.5e-5

# Number of points of the RITA rational-interpolation table for Rayleigh
# form-factor sampling (reference: MC-GPU_v1.3.h "NP_RAYLEIGH").
NP_RAYLEIGH = 128

# Cosine-angle acceptance threshold for detector tallies: particles deflected
# more than ~89 deg from the source direction never reach the detector
# (reference: MC-GPU_kernel_v1.3.cu:508).
TALLY_MIN_COS_ANGLE = 0.025

TWO_PI = 6.283185307179586
