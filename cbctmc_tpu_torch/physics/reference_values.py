"""The port's copy of the JAX package's calibration reference values
(measured/derived data from the reference pipeline,
cbctmc/mc/reference.py): attenuation coefficients at the 63.14 keV
mean spectrum energy and per-insert statistics of a real Varian TrueBeam
CatPhan604 scan. These are the acceptance targets of the fit-noise and
water-precorrection workflows."""

# linear attenuation [1/mm] at the 63.140 keV mean energy of the
# 125 kVp / 0.89 mm Ti spectrum (reference: mc/reference.py:4-15)
REFERENCE_MU = {
    "air": 0.000023674711138187246,
    "h2o": 0.020119709288519042,
    "teflon": 0.03943393182174662,
    "bone_050": 0.03480381262984748,
    "bone_020": 0.024925935187940915,
    "delrin": 0.02694022154936656,
    "acrylic": 0.022290157393600557,
    "polystyrene": 0.01896977750638363,
    "ldpe": 0.017862982216811124,
    "pmp": 0.016115516565166557,
}

# ROI mu values extracted from a real CatPhan604 Varian scan
# (reference: mc/reference.py:52-66)
REFERENCE_MU_VARIAN = {
    "h2o": 0.0204,
    "air": 0.004239453934133053,
    "air_1": 0.00420496566221118,
    "teflon": 0.033720940351486206,
    "delrin": 0.024775395169854164,
    "bone_020": 0.023067258298397064,
    "acrylic": 0.021296123042702675,
    "air_2": 0.004273942206054926,
    "polystyrene": 0.018962856382131577,
    "ldpe": 0.018118449300527573,
    "bone_050": 0.030424252897500992,
    "pmp": 0.016767635839927197,
}

# mean/std [1/mm] per CatPhan604 sensitometry insert of a measured Varian
# TrueBeam reconstruction — the noise-fit target
# (reference: mc/reference.py:172-283)
REFERENCE_ROI_STATS_CATPHAN604_VARIAN = {
    "air_1": {"mean": 0.004297331906855106, "std": 0.0008914025384001434},
    "teflon": {"mean": 0.03361523896455765, "std": 0.0010753646492958069},
    "delrin": {"mean": 0.02472609281539917, "std": 0.0010216617956757545},
    "bone_020": {"mean": 0.023070329800248146, "std": 0.0010106356348842382},
    "acrylic": {"mean": 0.02121036686003208, "std": 0.0010135178454220295},
    "air_2": {"mean": 0.00426891166716814, "std": 0.0009401424322277308},
    "polystyrene": {"mean": 0.018922727555036545, "std": 0.0009755354840308428},
    "ldpe": {"mean": 0.018143903464078903, "std": 0.001071136794053018},
    "bone_050": {"mean": 0.030341893434524536, "std": 0.001093234634026885},
    "pmp": {"mean": 0.016738785430788994, "std": 0.0009769928874447942},
    "water": {"mean": 0.020344505086541176, "std": 0.0010299131972715259},
}

# water precorrection polynomial fitted on CatPhan604
# (reference: cbctmc/defaults.py:13-20)
DEFAULT_WPC_CATPHAN604 = (
    0.7490896601034365,
    0.8853028842822823,
    0.15532901941332966,
    -0.08447728801183985,
    0.023960875121701974,
    -0.0025035454792714518,
)
