"""The port's figure model: a display list of the matplotlib calls that
``pipelines/plot.py`` and ``pipelines/visualize.py`` make, and no others.

The card's machine has no matplotlib, so the port keeps a model of its
own, drawn to PDF, SVG or PNG by ``utils/pdf.py``, ``utils/svg.py`` and
``utils/png.py`` (``Figure.savefig`` picks by the suffix). :func:`subplots` and
:func:`figure` give a :class:`Figure`; ``Figure.add_subplot`` gives an
:class:`Axes` (or an :class:`Axes3D` with ``projection="3d"``), and
``Figure.colorbar`` a :class:`Colorbar`. Each ``Axes`` call appends an
artist (:class:`Line`, :class:`Rectangle`, :class:`LineCollection`,
:class:`PathCollection`, :class:`ContourSet`, :class:`Surface`) that keeps
its data in float64 with its colour (RGBA), alpha, line style, marker and
label, so that a reader can hold it against what matplotlib was handed.

What follows matplotlib 3.10's rules, so that the numbers agree:

- the view limits of 2-D axes (``get_xlim``/``get_ylim``): the data limits
  widened by the 0.05 margins, in log space on log axes, stopped at the
  sticky edges that ``bar``/``hist`` (0) and ``contour`` (its grid) set;
  the autoscale is requested and applied at the moments matplotlib does
  (``axvline`` inside the view requests none; twins share their x view);
- ``contour(levels=N)``: ``MaxNLocator(N + 1)`` over [zmin, zmax], trimmed
  as ``ContourSet`` trims, and marching squares with linear interpolation
  along the cell edges; ``clabel``'s text per level (``ScalarFormatter``
  without offset);
- ``plot_surface``'s grid at ``rcount = ccount = 50``;
- the colours: the named ones the plots use, ``tab10`` (the default
  property cycle) and ``viridis``, copied as literals.

The tick locator is the port's own: 4-10 values of 1, 2, 2.5 or 5 x 10^n
inside the view. Layout and drawing are the port's own too (no
``tight_layout`` solver); they do not change any number above.
"""
import math
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

RGBA = Tuple[float, float, float, float]

#: the named colours the plots use (matplotlib's CSS4/Tableau table)
NAMED_COLORS = {
    "black": "#000000", "dodgerblue": "#1E90FF", "crimson": "#DC143C",
    "forestgreen": "#228B22", "darkorange": "#FF8C00",
    "slategray": "#708090", "mediumorchid": "#BA55D3",
    "tab:blue": "#1f77b4", "tab:orange": "#ff7f0e",
}
#: matplotlib's one-letter colours the plots use
BASE_COLORS = {"k": (0.0, 0.0, 0.0), "b": (0.0, 0.0, 1.0),
               "r": (1.0, 0.0, 0.0)}

#: ``tab10``, also matplotlib's default property cycle
TAB10 = (
    (0.12156862745098039, 0.4666666666666667, 0.7058823529411765),
    (1.0, 0.4980392156862745, 0.054901960784313725),
    (0.17254901960784313, 0.6274509803921569, 0.17254901960784313),
    (0.8392156862745098, 0.15294117647058825, 0.1568627450980392),
    (0.5803921568627451, 0.403921568627451, 0.7411764705882353),
    (0.5490196078431373, 0.33725490196078434, 0.29411764705882354),
    (0.8901960784313725, 0.4666666666666667, 0.7607843137254902),
    (0.4980392156862745, 0.4980392156862745, 0.4980392156862745),
    (0.7372549019607844, 0.7411764705882353, 0.13333333333333333),
    (0.09019607843137255, 0.7450980392156863, 0.8117647058823529),
)

#: the 256 entries of ``viridis`` (matplotlib ``_cm_listed._viridis_data``)
VIRIDIS = (
    (0.267004, 0.004874, 0.329415), (0.26851, 0.009605, 0.335427),
    (0.269944, 0.014625, 0.341379), (0.271305, 0.019942, 0.347269),
    (0.272594, 0.025563, 0.353093), (0.273809, 0.031497, 0.358853),
    (0.274952, 0.037752, 0.364543), (0.276022, 0.044167, 0.370164),
    (0.277018, 0.050344, 0.375715), (0.277941, 0.056324, 0.381191),
    (0.278791, 0.062145, 0.386592), (0.279566, 0.067836, 0.391917),
    (0.280267, 0.073417, 0.397163), (0.280894, 0.078907, 0.402329),
    (0.281446, 0.08432, 0.407414), (0.281924, 0.089666, 0.412415),
    (0.282327, 0.094955, 0.417331), (0.282656, 0.100196, 0.42216),
    (0.28291, 0.105393, 0.426902), (0.283091, 0.110553, 0.431554),
    (0.283197, 0.11568, 0.436115), (0.283229, 0.120777, 0.440584),
    (0.283187, 0.125848, 0.44496), (0.283072, 0.130895, 0.449241),
    (0.282884, 0.13592, 0.453427), (0.282623, 0.140926, 0.457517),
    (0.28229, 0.145912, 0.46151), (0.281887, 0.150881, 0.465405),
    (0.281412, 0.155834, 0.469201), (0.280868, 0.160771, 0.472899),
    (0.280255, 0.165693, 0.476498), (0.279574, 0.170599, 0.479997),
    (0.278826, 0.17549, 0.483397), (0.278012, 0.180367, 0.486697),
    (0.277134, 0.185228, 0.489898), (0.276194, 0.190074, 0.493001),
    (0.275191, 0.194905, 0.496005), (0.274128, 0.199721, 0.498911),
    (0.273006, 0.20452, 0.501721), (0.271828, 0.209303, 0.504434),
    (0.270595, 0.214069, 0.507052), (0.269308, 0.218818, 0.509577),
    (0.267968, 0.223549, 0.512008), (0.26658, 0.228262, 0.514349),
    (0.265145, 0.232956, 0.516599), (0.263663, 0.237631, 0.518762),
    (0.262138, 0.242286, 0.520837), (0.260571, 0.246922, 0.522828),
    (0.258965, 0.251537, 0.524736), (0.257322, 0.25613, 0.526563),
    (0.255645, 0.260703, 0.528312), (0.253935, 0.265254, 0.529983),
    (0.252194, 0.269783, 0.531579), (0.250425, 0.27429, 0.533103),
    (0.248629, 0.278775, 0.534556), (0.246811, 0.283237, 0.535941),
    (0.244972, 0.287675, 0.53726), (0.243113, 0.292092, 0.538516),
    (0.241237, 0.296485, 0.539709), (0.239346, 0.300855, 0.540844),
    (0.237441, 0.305202, 0.541921), (0.235526, 0.309527, 0.542944),
    (0.233603, 0.313828, 0.543914), (0.231674, 0.318106, 0.544834),
    (0.229739, 0.322361, 0.545706), (0.227802, 0.326594, 0.546532),
    (0.225863, 0.330805, 0.547314), (0.223925, 0.334994, 0.548053),
    (0.221989, 0.339161, 0.548752), (0.220057, 0.343307, 0.549413),
    (0.21813, 0.347432, 0.550038), (0.21621, 0.351535, 0.550627),
    (0.214298, 0.355619, 0.551184), (0.212395, 0.359683, 0.55171),
    (0.210503, 0.363727, 0.552206), (0.208623, 0.367752, 0.552675),
    (0.206756, 0.371758, 0.553117), (0.204903, 0.375746, 0.553533),
    (0.203063, 0.379716, 0.553925), (0.201239, 0.38367, 0.554294),
    (0.19943, 0.387607, 0.554642), (0.197636, 0.391528, 0.554969),
    (0.19586, 0.395433, 0.555276), (0.1941, 0.399323, 0.555565),
    (0.192357, 0.403199, 0.555836), (0.190631, 0.407061, 0.556089),
    (0.188923, 0.41091, 0.556326), (0.187231, 0.414746, 0.556547),
    (0.185556, 0.41857, 0.556753), (0.183898, 0.422383, 0.556944),
    (0.182256, 0.426184, 0.55712), (0.180629, 0.429975, 0.557282),
    (0.179019, 0.433756, 0.55743), (0.177423, 0.437527, 0.557565),
    (0.175841, 0.44129, 0.557685), (0.174274, 0.445044, 0.557792),
    (0.172719, 0.448791, 0.557885), (0.171176, 0.45253, 0.557965),
    (0.169646, 0.456262, 0.55803), (0.168126, 0.459988, 0.558082),
    (0.166617, 0.463708, 0.558119), (0.165117, 0.467423, 0.558141),
    (0.163625, 0.471133, 0.558148), (0.162142, 0.474838, 0.55814),
    (0.160665, 0.47854, 0.558115), (0.159194, 0.482237, 0.558073),
    (0.157729, 0.485932, 0.558013), (0.15627, 0.489624, 0.557936),
    (0.154815, 0.493313, 0.55784), (0.153364, 0.497, 0.557724),
    (0.151918, 0.500685, 0.557587), (0.150476, 0.504369, 0.55743),
    (0.149039, 0.508051, 0.55725), (0.147607, 0.511733, 0.557049),
    (0.14618, 0.515413, 0.556823), (0.144759, 0.519093, 0.556572),
    (0.143343, 0.522773, 0.556295), (0.141935, 0.526453, 0.555991),
    (0.140536, 0.530132, 0.555659), (0.139147, 0.533812, 0.555298),
    (0.13777, 0.537492, 0.554906), (0.136408, 0.541173, 0.554483),
    (0.135066, 0.544853, 0.554029), (0.133743, 0.548535, 0.553541),
    (0.132444, 0.552216, 0.553018), (0.131172, 0.555899, 0.552459),
    (0.129933, 0.559582, 0.551864), (0.128729, 0.563265, 0.551229),
    (0.127568, 0.566949, 0.550556), (0.126453, 0.570633, 0.549841),
    (0.125394, 0.574318, 0.549086), (0.124395, 0.578002, 0.548287),
    (0.123463, 0.581687, 0.547445), (0.122606, 0.585371, 0.546557),
    (0.121831, 0.589055, 0.545623), (0.121148, 0.592739, 0.544641),
    (0.120565, 0.596422, 0.543611), (0.120092, 0.600104, 0.54253),
    (0.119738, 0.603785, 0.5414), (0.119512, 0.607464, 0.540218),
    (0.119423, 0.611141, 0.538982), (0.119483, 0.614817, 0.537692),
    (0.119699, 0.61849, 0.536347), (0.120081, 0.622161, 0.534946),
    (0.120638, 0.625828, 0.533488), (0.12138, 0.629492, 0.531973),
    (0.122312, 0.633153, 0.530398), (0.123444, 0.636809, 0.528763),
    (0.12478, 0.640461, 0.527068), (0.126326, 0.644107, 0.525311),
    (0.128087, 0.647749, 0.523491), (0.130067, 0.651384, 0.521608),
    (0.132268, 0.655014, 0.519661), (0.134692, 0.658636, 0.517649),
    (0.137339, 0.662252, 0.515571), (0.14021, 0.665859, 0.513427),
    (0.143303, 0.669459, 0.511215), (0.146616, 0.67305, 0.508936),
    (0.150148, 0.676631, 0.506589), (0.153894, 0.680203, 0.504172),
    (0.157851, 0.683765, 0.501686), (0.162016, 0.687316, 0.499129),
    (0.166383, 0.690856, 0.496502), (0.170948, 0.694384, 0.493803),
    (0.175707, 0.6979, 0.491033), (0.180653, 0.701402, 0.488189),
    (0.185783, 0.704891, 0.485273), (0.19109, 0.708366, 0.482284),
    (0.196571, 0.711827, 0.479221), (0.202219, 0.715272, 0.476084),
    (0.20803, 0.718701, 0.472873), (0.214, 0.722114, 0.469588),
    (0.220124, 0.725509, 0.466226), (0.226397, 0.728888, 0.462789),
    (0.232815, 0.732247, 0.459277), (0.239374, 0.735588, 0.455688),
    (0.24607, 0.73891, 0.452024), (0.252899, 0.742211, 0.448284),
    (0.259857, 0.745492, 0.444467), (0.266941, 0.748751, 0.440573),
    (0.274149, 0.751988, 0.436601), (0.281477, 0.755203, 0.432552),
    (0.288921, 0.758394, 0.428426), (0.296479, 0.761561, 0.424223),
    (0.304148, 0.764704, 0.419943), (0.311925, 0.767822, 0.415586),
    (0.319809, 0.770914, 0.411152), (0.327796, 0.77398, 0.40664),
    (0.335885, 0.777018, 0.402049), (0.344074, 0.780029, 0.397381),
    (0.35236, 0.783011, 0.392636), (0.360741, 0.785964, 0.387814),
    (0.369214, 0.788888, 0.382914), (0.377779, 0.791781, 0.377939),
    (0.386433, 0.794644, 0.372886), (0.395174, 0.797475, 0.367757),
    (0.404001, 0.800275, 0.362552), (0.412913, 0.803041, 0.357269),
    (0.421908, 0.805774, 0.35191), (0.430983, 0.808473, 0.346476),
    (0.440137, 0.811138, 0.340967), (0.449368, 0.813768, 0.335384),
    (0.458674, 0.816363, 0.329727), (0.468053, 0.818921, 0.323998),
    (0.477504, 0.821444, 0.318195), (0.487026, 0.823929, 0.312321),
    (0.496615, 0.826376, 0.306377), (0.506271, 0.828786, 0.300362),
    (0.515992, 0.831158, 0.294279), (0.525776, 0.833491, 0.288127),
    (0.535621, 0.835785, 0.281908), (0.545524, 0.838039, 0.275626),
    (0.555484, 0.840254, 0.269281), (0.565498, 0.84243, 0.262877),
    (0.575563, 0.844566, 0.256415), (0.585678, 0.846661, 0.249897),
    (0.595839, 0.848717, 0.243329), (0.606045, 0.850733, 0.236712),
    (0.616293, 0.852709, 0.230052), (0.626579, 0.854645, 0.223353),
    (0.636902, 0.856542, 0.21662), (0.647257, 0.8584, 0.209861),
    (0.657642, 0.860219, 0.203082), (0.668054, 0.861999, 0.196293),
    (0.678489, 0.863742, 0.189503), (0.688944, 0.865448, 0.182725),
    (0.699415, 0.867117, 0.175971), (0.709898, 0.868751, 0.169257),
    (0.720391, 0.87035, 0.162603), (0.730889, 0.871916, 0.156029),
    (0.741388, 0.873449, 0.149561), (0.751884, 0.874951, 0.143228),
    (0.762373, 0.876424, 0.137064), (0.772852, 0.877868, 0.131109),
    (0.783315, 0.879285, 0.125405), (0.79376, 0.880678, 0.120005),
    (0.804182, 0.882046, 0.114965), (0.814576, 0.883393, 0.110347),
    (0.82494, 0.88472, 0.106217), (0.83527, 0.886029, 0.102646),
    (0.845561, 0.887322, 0.099702), (0.85581, 0.888601, 0.097452),
    (0.866013, 0.889868, 0.095953), (0.876168, 0.891125, 0.09525),
    (0.886271, 0.892374, 0.095374), (0.89632, 0.893616, 0.096335),
    (0.906311, 0.894855, 0.098125), (0.916242, 0.896091, 0.100717),
    (0.926106, 0.89733, 0.104071), (0.935904, 0.89857, 0.108131),
    (0.945636, 0.899815, 0.112838), (0.9553, 0.901065, 0.118128),
    (0.964894, 0.902323, 0.123941), (0.974417, 0.90359, 0.130215),
    (0.983868, 0.904867, 0.136897), (0.993248, 0.906157, 0.143936),
)

#: Helvetica's advance widths (1/1000 em) for the codes 32-126
#: (matplotlib ``mpl-data/fonts/afm/phvr8a.afm``)
HELVETICA_WIDTHS = (
    278, 278, 355, 556, 556, 889, 667, 222, 333, 333, 389, 584, 278, 333,
    278, 278, 556, 556, 556, 556, 556, 556, 556, 556, 556, 556, 278, 278,
    584, 584, 584, 556, 1015, 667, 667, 722, 722, 667, 611, 778, 722, 278,
    500, 667, 556, 833, 722, 778, 667, 778, 722, 667, 611, 722, 667, 944,
    667, 667, 611, 278, 278, 278, 469, 556, 222, 556, 556, 500, 556, 556,
    278, 556, 556, 222, 222, 500, 222, 833, 556, 556, 556, 556, 333, 500,
    278, 556, 500, 722, 500, 500, 500, 334, 260, 334, 584)

#: matplotlib's ``axes.xmargin``/``axes.ymargin``
MARGIN = 0.05
#: ``plot_surface``'s default most rows and columns it samples
SURFACE_COUNT = 50
#: ``ContourSet``/``ScalarFormatter`` power limits (``axes.formatter.limits``)
POWER_LIMITS = (-5, 6)


# -- colours -------------------------------------------------------------

def to_rgba(color, alpha: Optional[float] = None) -> RGBA:
    """An RGBA tuple of floats from a name, a one-letter colour, a hex
    string or an RGB(A) sequence; ``alpha`` replaces the alpha channel
    ('none' stays transparent), as ``matplotlib.colors.to_rgba``."""
    if isinstance(color, str):
        name = color.lower()
        if name == "none":
            return (0.0, 0.0, 0.0, 0.0)
        if color in BASE_COLORS:
            rgb = BASE_COLORS[color]
        else:
            hexa = NAMED_COLORS.get(name, name)
            if not (hexa.startswith("#") and len(hexa) in (7, 9)):
                raise ValueError(f"unknown colour {color!r}")
            rgb = tuple(int(hexa[i:i + 2], 16) / 255 for i in (1, 3, 5))
            if len(hexa) == 9 and alpha is None:
                alpha = int(hexa[7:9], 16) / 255
        return (*(float(c) for c in rgb), 1.0 if alpha is None
                else float(alpha))
    c = tuple(float(v) for v in color)
    if len(c) not in (3, 4):
        raise ValueError(f"colour {color!r} is not RGB or RGBA")
    a = alpha if alpha is not None else (c[3] if len(c) == 4 else 1.0)
    return (c[0], c[1], c[2], float(a))


class Colormap:
    """A listed colormap (matplotlib ``ListedColormap``): a float in
    [0, 1] picks ``int(x * N)`` (1 picks the last entry, below 0 the first,
    above 1 the last, NaN transparent); an integer picks its entry."""

    def __init__(self, name: str, colors: Sequence[Sequence[float]]):
        self.name = name
        self.lut = np.concatenate([np.asarray(colors, np.float64),
                                   np.ones((len(colors), 1))], axis=1)
        self.N = len(colors)

    def __call__(self, x, alpha: Optional[float] = None):
        xa = np.array(x, copy=True)
        scalar = xa.ndim == 0
        xa = np.atleast_1d(xa)
        bad = np.zeros(xa.shape, bool)
        if xa.dtype.kind == "f":
            xa = xa * self.N
            xa[xa == self.N] = self.N - 1
            bad = np.isnan(xa)
        under, over = xa < 0, xa >= self.N
        with np.errstate(invalid="ignore"):
            idx = xa.astype(int)
        idx[under] = 0
        idx[over] = self.N - 1
        idx[bad] = 0
        out = self.lut[idx]
        out[bad] = 0.0
        if alpha is not None:
            out[~bad, 3] = alpha
        if scalar:
            return tuple(float(v) for v in out[0])
        return out


_CMAPS = {"viridis": VIRIDIS, "tab10": TAB10}


def get_cmap(name: str) -> Colormap:
    """``viridis`` or ``tab10``."""
    if name not in _CMAPS:
        raise ValueError(f"colormap {name!r}: the port has "
                         f"{sorted(_CMAPS)}")
    return Colormap(name, _CMAPS[name])


class Normalize:
    """Linear map of [vmin, vmax] onto [0, 1], scaled to the data on
    first use (matplotlib ``Normalize``)."""

    def __init__(self, vmin=None, vmax=None):
        self.vmin, self.vmax = vmin, vmax

    def autoscale_none(self, values):
        v = np.asarray(values, np.float64)
        if self.vmin is None and v.size:
            self.vmin = float(v.min())
        if self.vmax is None and v.size:
            self.vmax = float(v.max())

    def __call__(self, values) -> np.ndarray:
        v = np.array(values, np.float64)
        self.autoscale_none(v)
        if self.vmin == self.vmax:
            return np.zeros_like(v)
        return (v - self.vmin) / (self.vmax - self.vmin)


# -- the limit rules ---------------------------------------------------

def nonsingular(vmin, vmax, expander=0.001, tiny=1e-15):
    """matplotlib ``transforms.nonsingular``: widen an empty or
    non-finite interval."""
    if not (np.isfinite(vmin) and np.isfinite(vmax)):
        return -expander, expander
    swapped = vmax < vmin
    if swapped:
        vmin, vmax = vmax, vmin
    vmin, vmax = float(vmin), float(vmax)
    maxabs = max(abs(vmin), abs(vmax))
    if maxabs < (1e6 / tiny) * np.finfo(float).tiny:
        vmin, vmax = -expander, expander
    elif vmax - vmin <= maxabs * tiny:
        if vmax == 0 and vmin == 0:
            vmin, vmax = -expander, expander
        else:
            vmin -= expander * abs(vmin)
            vmax += expander * abs(vmax)
    return (vmax, vmin) if swapped else (vmin, vmax)


def _decade_less(x: float) -> float:
    le = 10.0 ** np.floor(np.log(x) / np.log(10.0))
    return le / 10.0 if le == x else le


def _decade_greater(x: float) -> float:
    ge = 10.0 ** np.ceil(np.log(x) / np.log(10.0))
    return ge * 10.0 if ge == x else ge


# -- tick and level locators -----------------------------------------

_STEPS = np.array([1, 1.5, 2, 2.5, 3, 4, 5, 6, 8, 10])
_EXTENDED_STEPS = np.concatenate([0.1 * _STEPS[:-1], _STEPS,
                                  [10 * _STEPS[1]]])


def _scale_range(vmin, vmax, n=1, threshold=100):
    dv = abs(vmax - vmin)
    meanv = (vmax + vmin) / 2
    if abs(meanv) / dv < threshold:
        offset = 0
    else:
        offset = math.copysign(10 ** (math.log10(abs(meanv)) // 1), meanv)
    return 10 ** (math.log10(dv / n) // 1), offset


def _edge_close(ms, edge, step, offset):
    if offset > 0:
        digits = np.log10(offset / step)
        tol = min(0.4999, max(1e-10, 10 ** (digits - 12)))
    else:
        tol = 1e-10
    return abs(ms - edge) < tol


def max_n_locator(vmin: float, vmax: float, nbins: int,
                  min_n_ticks: int = 2) -> np.ndarray:
    """matplotlib ``MaxNLocator(nbins, min_n_ticks).tick_values`` with the
    default steps (1, 1.5, 2, 2.5, 3, 4, 5, 6, 8, 10)."""
    vmin, vmax = nonsingular(vmin, vmax, expander=1e-13, tiny=1e-14)
    scale, offset = _scale_range(vmin, vmax, nbins)
    _vmin, _vmax = vmin - offset, vmax - offset
    steps = _EXTENDED_STEPS * scale
    raw_step = (_vmax - _vmin) / nbins
    large = steps >= raw_step
    istep = np.nonzero(large)[0][0] if large.any() else len(steps) - 1
    off = abs(offset)
    for step in steps[:istep + 1][::-1]:
        best_vmin = (_vmin // step) * step
        d, m = divmod(_vmin - best_vmin, step)
        low = d + 1 if _edge_close(m / step, 1, step, off) else d
        d, m = divmod(_vmax - best_vmin, step)
        high = d if _edge_close(m / step, 0, step, off) else d + 1
        ticks = np.arange(low, high + 1) * step + best_vmin
        if ((ticks <= _vmax) & (ticks >= _vmin)).sum() >= min_n_ticks:
            break
    return ticks + offset


def contour_levels(zmin: float, zmax: float, n: int) -> np.ndarray:
    """``contour(levels=n)``'s levels: ``MaxNLocator(n + 1,
    min_n_ticks=1)`` over [zmin, zmax], the excess trimmed as
    ``ContourSet._autolev`` trims for line contours."""
    lev = max_n_locator(zmin, zmax, n + 1, min_n_ticks=1)
    under = np.nonzero(lev < zmin)[0]
    i0 = under[-1] if len(under) else 0
    over = np.nonzero(lev > zmax)[0]
    i1 = over[0] + 1 if len(over) else len(lev)
    if i1 - i0 < 3:
        i0, i1 = 0, len(lev)
    return np.asarray(lev[i0:i1], np.float64)


def level_texts(levels: Sequence[float]) -> List[str]:
    """``clabel``'s text of each level: matplotlib's
    ``ScalarFormatter(useOffset=False)`` on a dummy axis (view [0, 1]),
    formatting ``[*levels, level]``; a minus sign is U+2212."""
    out = []
    levels = [float(v) for v in levels]
    for lev in levels:
        locs = np.asarray(levels + [lev])
        visible = np.abs(locs[(locs >= 0) & (locs <= 1)])
        oom = 0
        if len(visible):
            val = visible.max()
            o = 0 if val == 0 else math.floor(math.log10(val))
            if o <= POWER_LIMITS[0] or o >= POWER_LIMITS[1]:
                oom = o
        scaled = locs / 10.0 ** oom
        loc_range = np.ptp(scaled)
        if loc_range == 0:
            loc_range = np.max(np.abs(scaled))
        if loc_range == 0:
            loc_range = 1
        range_oom = int(math.floor(math.log10(loc_range)))
        sigfigs = max(0, 3 - range_oom)
        thresh = 1e-3 * 10 ** range_oom
        while sigfigs >= 0:
            if np.abs(scaled - np.round(scaled, decimals=sigfigs)).max() \
                    < thresh:
                sigfigs -= 1
            else:
                break
        sigfigs += 1
        xp = lev / 10.0 ** oom
        if abs(xp) < 1e-8:
            xp = 0
        out.append((f"%1.{sigfigs}f" % xp).replace("-", "−"))
    return out


def nice_ticks(lo: float, hi: float) -> np.ndarray:
    """The port's tick locator: 4-10 values of 1, 2, 2.5 or 5 x 10^n
    inside [lo, hi] (fewer only when no step gives 4)."""
    if not (np.isfinite(lo) and np.isfinite(hi)) or hi <= lo:
        return np.array([lo]) if np.isfinite(lo) else np.array([])
    base = math.floor(math.log10(hi - lo)) - 2
    fallback = None
    for e in range(base, base + 4):
        for m in (1, 2, 2.5, 5):
            step = m * 10.0 ** e
            first = math.ceil(lo / step - 1e-9)
            last = math.floor(hi / step + 1e-9)
            n = last - first + 1
            if n <= 10:
                ticks = np.arange(first, last + 1) * step
                if n >= 4:
                    return ticks
                if fallback is None:
                    fallback = ticks
    return fallback if fallback is not None else np.array([lo, hi])


def log_ticks(lo: float, hi: float) -> np.ndarray:
    """Decades inside [lo, hi] (every k-th so that at most 10 remain); the
    linear locator where the view holds no decade."""
    k0, k1 = math.ceil(math.log10(lo) - 1e-9), math.floor(
        math.log10(hi) + 1e-9)
    if k1 < k0:
        return nice_ticks(lo, hi)
    every = max(1, math.ceil((k1 - k0 + 1) / 10))
    return 10.0 ** np.arange(k0, k1 + 1, every)


def tick_texts(ticks: np.ndarray, log: bool = False) -> List[str]:
    """Labels for the port's ticks: fixed decimals from the step; decades
    outside [1e-3, 1e4] as ``1e<k>``."""
    if log:
        return [f"1e{round(math.log10(t))}" if not 1e-3 <= t <= 1e4
                else f"{t:g}" for t in ticks]
    if len(ticks) < 2:
        return [f"{t:g}" for t in ticks]
    step = float(np.min(np.diff(ticks)))
    digits = 0
    while digits < 12 and abs(round(step * 10 ** digits)
                              - step * 10 ** digits) > 1e-6 * 10 ** digits:
        digits += 1
    out = []
    for t in ticks:
        s = f"{t:.{digits}f}"
        out.append("0" if float(s) == 0 and digits == 0 else
                   s if float(s) != 0 else f"{0:.{digits}f}")
    return out


# -- contours ------------------------------------------------------------

def marching_squares(x: np.ndarray, y: np.ndarray, z: np.ndarray,
                     level: float) -> List[np.ndarray]:
    """The level set of ``z[len(y), len(x)]`` at ``level`` as [2, 2]
    segments, one or two per grid cell: a point on each cell edge whose
    corners straddle the level (above means ``z > level``), placed by
    linear interpolation; a saddle joins by the cell's mean."""
    segs = []
    above = z > level

    def cross(p, q):
        # one order per edge, so that the two cells sharing it agree
        (i0, j0), (i1, j1) = sorted((p, q))
        z0, z1 = z[i0, j0], z[i1, j1]
        f = (level - z0) / (z1 - z0)
        return (x[j0] + f * (x[j1] - x[j0]), y[i0] + f * (y[i1] - y[i0]))

    for i in range(z.shape[0] - 1):
        for j in range(z.shape[1] - 1):
            corners = ((i, j), (i, j + 1), (i + 1, j + 1), (i + 1, j))
            flags = [above[c] for c in corners]
            if all(flags) or not any(flags):
                continue
            edges = [(corners[k], corners[(k + 1) % 4]) for k in range(4)
                     if flags[k] != flags[(k + 1) % 4]]
            pts = [cross(p, q) for p, q in edges]
            if len(pts) == 2:
                segs.append(np.array(pts))
                continue
            # a saddle: the cell's mean decides which corners connect
            centre = np.mean([z[c] for c in corners]) > level
            if centre == flags[0]:
                pairs = ((0, 3), (1, 2)) if edges[0][0] == corners[0] \
                    else ((0, 1), (2, 3))
            else:
                pairs = ((0, 1), (2, 3)) if edges[0][0] == corners[0] \
                    else ((0, 3), (1, 2))
            for a, b in pairs:
                segs.append(np.array([pts[a], pts[b]]))
    return segs


# -- artists -------------------------------------------------------------

class Artist:
    """What every artist keeps: label (None or a string; one starting with
    '_' or empty stays out of the legend), alpha, z-order and sticky
    edges."""
    zorder = 1.0

    def __init__(self, label=None, alpha=None):
        self.label = None if label is None else str(label)
        self.alpha = alpha
        self.sticky_x: List[float] = []
        self.sticky_y: List[float] = []

    @property
    def in_legend(self) -> bool:
        return bool(self.label) and not self.label.startswith("_")


class Line(Artist):
    """``plot``/``semilogy``/``axvline``: x, y in float64; ``axis_y``
    marks ``axvline``'s y, a fraction of the axes."""
    zorder = 2.0

    def __init__(self, x, y, color: RGBA, linestyle="-", marker="None",
                 linewidth=1.5, markersize=6.0, label=None, alpha=None,
                 axis_y=False):
        super().__init__(label, alpha)
        self.x = np.asarray(x, np.float64).ravel()
        self.y = np.asarray(y, np.float64).ravel()
        self.color, self.linestyle, self.marker = color, linestyle, marker
        self.linewidth, self.markersize = linewidth, markersize
        self.axis_y = axis_y


class Rectangle(Artist):
    """One bar of ``bar``/``hist``: its corner (x, y), width, height,
    face and edge colours (RGBA with the alpha applied) and hatch."""

    def __init__(self, x, y, width, height, facecolor: RGBA,
                 edgecolor: RGBA, hatch=None, linewidth=1.0, label=None,
                 alpha=None):
        super().__init__(label, alpha)
        self.x, self.y = float(x), float(y)
        self.width, self.height = float(width), float(height)
        self.facecolor, self.edgecolor = facecolor, edgecolor
        self.hatch, self.linewidth = hatch, linewidth


class Container:
    """The bars of one ``bar`` call, under its legend label."""

    def __init__(self, patches: List[Rectangle], label=None):
        self.patches, self.label = patches, label

    @property
    def in_legend(self) -> bool:
        return bool(self.label) and not self.label.startswith("_")


class LineCollection(Artist):
    """``vlines``: [n, 2, 2] segments."""
    zorder = 2.0

    def __init__(self, segments, color: RGBA, linewidth=1.5, label=None,
                 alpha=None):
        super().__init__(label, alpha)
        self.segments = np.asarray(segments, np.float64).reshape(-1, 2, 2)
        self.color, self.linewidth = color, linewidth


class PathCollection(Artist):
    """``scatter``: offsets [n, 2], sizes (points^2), the marker, face
    colours [n, 4]; with ``c=`` the array, colormap and norm that map
    it."""

    def __init__(self, offsets, sizes, marker, facecolors, array=None,
                 cmap: Optional[Colormap] = None, norm=None, label=None,
                 alpha=None):
        super().__init__(label, alpha)
        self.offsets = np.asarray(offsets, np.float64).reshape(-1, 2)
        self.sizes = np.broadcast_to(np.asarray(sizes, np.float64),
                                     (len(self.offsets),)).copy()
        self.marker = marker
        self._facecolors = None if facecolors is None else \
            np.asarray(facecolors, np.float64).reshape(-1, 4)
        self.array = None if array is None else \
            np.asarray(array, np.float64).ravel()
        self.cmap, self.norm = cmap, norm
        self.colorbar: Optional["Colorbar"] = None

    @property
    def facecolors(self) -> np.ndarray:
        """The face colours; with ``c=`` the array through the norm and
        the colormap (at draw time, as matplotlib maps them)."""
        if self.array is not None:
            return self.cmap(self.norm(self.array), self.alpha)
        return self._facecolors


class ContourSet(Artist):
    """``contour``: the levels, each level's segments ([2, 2] arrays) and
    colour, and ``clabel``'s text per level."""

    def __init__(self, levels, allsegs, colors, label=None):
        super().__init__(label)
        self.levels = np.asarray(levels, np.float64)
        self.allsegs = allsegs
        self.colors = colors
        self.label_texts: List[str] = []
        self.label_fontsize: Optional[float] = None


class Surface(Artist):
    """``plot_surface``: the sampled grid (``row_inds``, ``col_inds`` of
    matplotlib's strides), its [k, 3] perimeter polygons and their face
    colours."""

    def __init__(self, polys, facecolors, rstride, cstride, row_inds,
                 col_inds):
        super().__init__()
        self.polys, self.facecolors = polys, facecolors
        self.rstride, self.cstride = rstride, cstride
        self.row_inds, self.col_inds = row_inds, col_inds


class Legend:
    """``legend``: the entries (artist, text) in matplotlib's order (the
    axes' artists first, then the ``bar`` containers), frame and font
    size."""

    def __init__(self, entries, frameon=True, fontsize=None):
        self.entries = entries
        self.texts = [t for _, t in entries]
        self.frameon = frameon
        self.fontsize = fontsize


class Colorbar:
    """``Figure.colorbar``: the mappable, its [vmin, vmax] (made
    non-singular, expander 0.1) and label; ``ax`` is the bar's axes."""

    def __init__(self, mappable: PathCollection, ax: "Axes", label=""):
        norm = mappable.norm
        norm.vmin, norm.vmax = nonsingular(norm.vmin, norm.vmax,
                                           expander=0.1)
        bounds = norm.vmin + np.linspace(0.0, 1.0, mappable.cmap.N + 1) \
            * (norm.vmax - norm.vmin)
        self.vmin, self.vmax = float(bounds[0]), float(bounds[-1])
        self.mappable, self.ax, self.label = mappable, ax, label
        mappable.colorbar = self
        ax.set_ylabel(label)
        ax._set_view("y", self.vmin, self.vmax)
        ax._set_view("x", 0.0, 1.0)
        ax.colorbar = self


# -- axes ----------------------------------------------------------------

class _Shared:
    """One axis direction's state shared by twins: the view interval,
    the scale and the locator kind ('auto', 'fixed', 'log')."""

    def __init__(self, axes):
        self.axes = [axes]
        self.view = [0.0, 1.0]
        self.mutated = False
        self.scale = "linear"
        self.locator = "auto"


class Axes:
    """A 2-D axes: the artists in call order (``children``), the ``bar``
    containers, labels, title, scales, ticks, legend, and the data limits
    and view limits under matplotlib's autoscaling."""
    name = "rectilinear"

    def __init__(self, figure: "Figure", rect, sharex: "Axes" = None):
        self.figure, self.rect = figure, list(rect)
        self.children: List[Artist] = []
        self.containers: List[Container] = []
        self.xlabel = self.ylabel = self.title = ""
        self.ylabel_color: RGBA = (0.0, 0.0, 0.0, 1.0)
        self.xticks: Optional[np.ndarray] = None
        self.xticklabels: Optional[List[str]] = None
        self.xticklabel_rotation, self.xticklabel_fontsize = 0.0, None
        self.legend_: Optional[Legend] = None
        self.colorbar: Optional[Colorbar] = None
        self.y_right = False            # a twin's y axis is on the right
        self.x_visible = self.frame_on = True
        self._cycle = 0
        self._tight = None
        self._stale = {"x": False, "y": False}
        self._datalim = {"x": [np.inf, -np.inf, np.inf],
                         "y": [np.inf, -np.inf, np.inf]}
        self._shared = {"x": _Shared(self), "y": _Shared(self)}
        if sharex is not None:
            group = sharex._shared["x"]
            group.axes.append(self)
            self._shared["x"] = group
            sharex._unstale()

    # -- artists, by kind ------------------------------------------------
    @property
    def lines(self) -> List[Line]:
        return [a for a in self.children if isinstance(a, Line)]

    @property
    def patches(self) -> List[Rectangle]:
        return [a for a in self.children if isinstance(a, Rectangle)]

    @property
    def collections(self) -> List[Artist]:
        return [a for a in self.children
                if isinstance(a, (LineCollection, PathCollection,
                                  ContourSet, Surface))]

    # -- scales and limits -------------------------------------------------
    def get_xscale(self) -> str:
        return self._shared["x"].scale

    def get_yscale(self) -> str:
        return self._shared["y"].scale

    def get_xlim(self) -> Tuple[float, float]:
        self._unstale()
        return tuple(self._shared["x"].view)

    def get_ylim(self) -> Tuple[float, float]:
        self._unstale()
        return tuple(self._shared["y"].view)

    def _request(self, *names):
        for name in names:
            self._stale[name] = True

    def _unstale(self):
        need = {n: any(a._stale[n] for a in self._shared[n].axes)
                for n in "xy"}
        if any(need.values()):
            for n in "xy":
                for a in self._shared[n].axes:
                    a._stale[n] = False
            self.autoscale_view(scalex=need["x"], scaley=need["y"])

    def _update_datalim(self, xy, updatex=True, updatey=True):
        xy = np.asarray(xy, np.float64).reshape(-1, 2)
        xy = xy[np.isfinite(xy).all(axis=1)]
        if not len(xy):
            return
        for i, name, on in ((0, "x", updatex), (1, "y", updatey)):
            if on:
                v, lim = xy[:, i], self._datalim[name]
                lim[0], lim[1] = min(lim[0], v.min()), max(lim[1], v.max())
                pos = v[v > 0]
                if len(pos):
                    lim[2] = min(lim[2], pos.min())

    def data_limits(self, name) -> Tuple[float, float]:
        """The data limits of axis ``name`` ('x' or 'y') over the axes
        that share it."""
        group = self._shared[name].axes
        return (min(a._datalim[name][0] for a in group),
                max(a._datalim[name][1] for a in group))

    def _minpos(self, name) -> float:
        return min(a._datalim[name][2] for a in self._shared[name].axes)

    def _locator_nonsingular(self, name, v0, v1):
        group = self._shared[name]
        if group.scale != "log":
            return nonsingular(v0, v1, expander=0.05)
        if v0 > v1:
            v0, v1 = v1, v0
        if not (np.isfinite(v0) and np.isfinite(v1)) or v1 <= 0:
            return 1.0, 10.0
        minpos = self._minpos(name)
        if not np.isfinite(minpos):
            minpos = 1e-300
        if v0 <= 0:
            v0 = minpos
        if v0 == v1:
            v0, v1 = _decade_less(v0), _decade_greater(v1)
        return v0, v1

    def _view_limits(self, name, v0, v1):
        group = self._shared[name]
        if group.scale == "log":
            return self._locator_nonsingular(name, v0, v1)
        if group.locator == "fixed":
            return nonsingular(v0, v1)
        return nonsingular(v0, v1, expander=1e-12, tiny=1e-13)

    def _set_view(self, name, v0, v1):
        """``set_xlim``/``set_ylim`` as autoscaling calls them."""
        group = self._shared[name]
        log = group.scale == "log"
        if log and (v0 <= 0 or v1 <= 0):
            v0 = group.view[0] if v0 <= 0 else v0
            v1 = group.view[1] if v1 <= 0 else v1
        reverse = bool(v0 > v1)
        v0, v1 = self._locator_nonsingular(name, v0, v1)
        if log:
            minpos = self._datalim[name][2]
            minpos = 1e-300 if not np.isfinite(minpos) else minpos
            v0 = minpos if v0 <= 0 else v0
            v1 = minpos if v1 <= 0 else v1
        v0, v1 = sorted([v0, v1], reverse=reverse)
        group.view = [float(v0), float(v1)]
        group.mutated = group.view != [0.0, 1.0]
        for a in group.axes:
            a._stale[name] = False

    def autoscale_view(self, tight=None, scalex=True, scaley=True):
        """matplotlib ``Axes.autoscale_view``: data limits of the shared
        axes, the locator's non-singular rule, the margins in the scale's
        space, the sticky edges, the view-limit rule."""
        if tight is not None:
            self._tight = bool(tight)
        for name, scale in (("x", scalex), ("y", scaley)):
            if not scale:
                continue
            group = self._shared[name]
            log = group.scale == "log"
            stickies = np.sort(np.asarray(
                [v for a in group.axes for art in a.children
                 for v in (art.sticky_x if name == "x" else art.sticky_y)],
                np.float64))
            if log:
                stickies = stickies[stickies > 0]
            values = [v for a in group.axes for v in a._datalim[name][:2]
                      if np.isfinite(v)]
            if values:
                x0, x1 = min(values), max(values)
            elif group.mutated:
                continue
            else:
                x0, x1 = -np.inf, np.inf
            x0, x1 = self._locator_nonsingular(name, x0, x1)
            minpos = self._minpos(name)
            tol = 1e-5 * abs(x1 - x0)
            i0 = int(np.searchsorted(stickies, x0 + tol)) - 1
            x0bound = stickies[i0] if i0 != -1 else None
            i1 = int(np.searchsorted(stickies, x1 - tol))
            x1bound = stickies[i1] if i1 != len(stickies) else None
            if log:
                minpos = 1e-300 if not np.isfinite(minpos) else minpos
                x0 = minpos if x0 <= 0 else x0
                x1 = minpos if x1 <= 0 else x1
                with np.errstate(divide="ignore", invalid="ignore"):
                    t = np.log10(np.array([[x0], [x1]], np.float64))
                t[np.array([[x0], [x1]]) <= 0] = -1000
            else:
                t = np.array([[x0], [x1]], np.float64)
            delta = (t[1, 0] - t[0, 0]) * MARGIN
            if not np.isfinite(delta):
                delta = 0
            t = np.array([[t[0, 0] - delta], [t[1, 0] + delta]])
            if log:
                t = np.power(10.0, t)
            x0, x1 = float(t[0, 0]), float(t[1, 0])
            if x0bound is not None:
                x0 = max(x0, float(x0bound))
            if x1bound is not None:
                x1 = min(x1, float(x1bound))
            if not self._tight:
                x0, x1 = self._view_limits(name, x0, x1)
            self._unstale()                 # set_xbound reads the bounds
            self._set_view(name, x0, x1)

    def _set_scale(self, name, scale):
        group = self._shared[name]
        old = self._locator_nonsingular(name, -np.inf, np.inf)
        group.scale = scale
        group.locator = "log" if scale == "log" else "auto"
        if self._locator_nonsingular(name, -np.inf, np.inf) != old:
            self.autoscale_view(scalex=name == "x", scaley=name == "y")

    def set_yscale(self, scale: str):
        self._set_scale("y", scale)

    # -- drawing calls ---------------------------------------------------
    def _next_color(self) -> RGBA:
        color = to_rgba(TAB10[self._cycle % len(TAB10)])
        self._cycle += 1
        return color

    def _add(self, artist: Artist) -> Artist:
        if artist.label is None or artist.label == "":
            artist.label = f"_child{len(self.children)}"
        self.children.append(artist)
        return artist

    def plot(self, *args, color=None, linestyle=None, marker=None,
             linewidth=None, label=None, alpha=None):
        """``plot(y)``, ``plot(x, y)`` or ``plot(x, y, fmt)`` with a format
        of a one-letter colour and a line style ('-', '--', ':')."""
        fmt = args[-1] if isinstance(args[-1], str) else None
        data = args[:-1] if fmt is not None else args
        if len(data) == 1:
            y = np.asarray(data[0], np.float64).ravel()
            x = np.arange(len(y), dtype=np.float64)
        else:
            x, y = data
        if fmt:
            for style in ("--", "-.", ":", "-"):
                if style in fmt:
                    linestyle = linestyle or style
                    fmt = fmt.replace(style, "", 1)
                    break
            if fmt:
                color = color if color is not None else fmt
        if color is None:
            color = self._next_color()
        line = Line(x, y, to_rgba(color), linestyle or "-",
                    marker or "None", linewidth or 1.5, label=label,
                    alpha=alpha)
        self._update_datalim(np.stack([line.x, line.y], axis=1))
        self._add(line)
        self._request("x", "y")
        return [line]

    def semilogy(self, *args, **kwargs):
        self.set_yscale("log")
        return self.plot(*args, **kwargs)

    def bar(self, x, height, width=0.8, bottom=None, color=None,
            edgecolor=None, hatch=None, label=None, alpha=None):
        """Vertical bars centred on ``x``; each bar's bottom is a sticky
        y edge."""
        x = np.atleast_1d(np.asarray(x))
        height = np.atleast_1d(np.asarray(height))
        n = max(len(x), len(height))
        x, height = np.broadcast_to(x, (n,)), np.broadcast_to(height, (n,))
        width = np.broadcast_to(np.asarray(width), (n,))
        bottom = np.broadcast_to(np.asarray(0.0 if bottom is None
                                            else bottom), (n,))
        if color is None:
            color = self._next_color()
        face = to_rgba(color, alpha)
        edge = (0.0, 0.0, 0.0, 0.0) if edgecolor is None else \
            to_rgba(edgecolor, alpha)
        left = x - width / 2
        patches = []
        for l, b, w, h in zip(left, bottom, width, height):
            r = Rectangle(l, b, w, h, face, edge, hatch, label="_nolegend_",
                          alpha=alpha)
            r.sticky_y.append(float(b))
            if w or h:
                self._update_datalim([(l, b), (l + w, b), (l + w, b + h),
                                      (l, b + h)])
            self._add(r)
            patches.append(r)
        self.containers.append(Container(patches, label))
        self._request("x", "y")
        return patches

    def hist(self, x, bins=10, density=False, color=None, edgecolor=None,
             alpha=None, label=None):
        """``numpy.histogram`` of ``x`` drawn as bars from 0; the first bar
        carries the label. Returns (counts, edges, patches)."""
        counts, edges = np.histogram(np.asarray(x), bins, density=density)
        if color is None:
            color = self._next_color()
        totwidth = np.diff(edges)
        patches = self.bar(edges[:-1] + 0.5 * totwidth, counts, totwidth,
                           bottom=np.zeros(len(counts)), color=color,
                           edgecolor=edgecolor, alpha=alpha)
        self.containers[-1].label = ""
        if patches and label is not None:
            patches[0].label = str(label)
        return counts, edges, patches

    def axvline(self, x, color="k", linestyle="-", linewidth=None,
                alpha=None, label=None):
        """A vertical line over the axes' height; it re-requests the x
        autoscale only when it lies outside the current view."""
        lo, hi = sorted(self.get_xlim())
        line = Line([x, x], [0.0, 1.0], to_rgba(color), linestyle,
                    "None", linewidth or 1.5, label=label, alpha=alpha,
                    axis_y=True)
        self._update_datalim([(x, 0.0), (x, 1.0)], updatey=False)
        self._add(line)
        if x < lo or x > hi:
            self._request("x")
        return line

    def vlines(self, x, ymin, ymax, color="k", alpha=None, linewidth=None,
               label=None):
        x = np.atleast_1d(np.asarray(x, np.float64))
        segs = np.zeros((len(x), 2, 2))
        segs[:, 0, 0] = segs[:, 1, 0] = x
        segs[:, 0, 1] = ymin
        segs[:, 1, 1] = ymax
        coll = LineCollection(segs, to_rgba(color), linewidth or 1.5,
                              label=label, alpha=alpha)
        self._add(coll)
        if len(x):
            # matplotlib takes a line collection's extent in the scales'
            # space (log10 on a log axis) and adds its corners as data
            pts = segs.reshape(-1, 2).copy()
            for i, name in ((0, "x"), (1, "y")):
                if self._shared[name].scale == "log":
                    with np.errstate(divide="ignore", invalid="ignore"):
                        v = np.log10(pts[:, i])
                    pts[:, i] = np.where(pts[:, i] > 0, v, -1000.0)
            self._update_datalim([(np.nanmin(pts[:, 0]), np.nanmin(pts[:, 1])),
                                  (np.nanmax(pts[:, 0]),
                                   np.nanmax(pts[:, 1]))])
            self._request("x", "y")
        return coll

    def scatter(self, x, y, s=None, c=None, cmap=None, marker="o",
                color=None, label=None, alpha=None):
        """Markers at (x, y), of area ``s`` points^2 (default 36), coloured
        by ``c`` through ``cmap`` or by ``color``."""
        offsets = np.stack([np.asarray(x, np.float64).ravel(),
                            np.asarray(y, np.float64).ravel()], axis=1)
        sizes = 36.0 if s is None else s
        if c is not None:
            norm = Normalize()
            norm.autoscale_none(c)
            coll = PathCollection(offsets, sizes, marker, None, c,
                                  get_cmap(cmap or "viridis"), norm, label,
                                  alpha)
        else:
            face = to_rgba(color if color is not None
                           else self._next_color(), alpha)
            coll = PathCollection(offsets, sizes, marker,
                                  [face] * len(offsets), label=label,
                                  alpha=alpha)
        self._add(coll)
        self._unstale()
        xy = offsets[np.isfinite(offsets).all(axis=1)]
        if len(xy):
            pts = [xy.min(axis=0), xy.max(axis=0)]
            minpos = [xy[xy[:, i] > 0, i].min() if (xy[:, i] > 0).any()
                      else np.inf for i in (0, 1)]
            if not np.isinf(minpos).all():
                pts.append(minpos)
            self._update_datalim(pts)
        self._request("x", "y")
        return coll

    def contour(self, x, y, z, levels=7, cmap="viridis"):
        """Line contours of ``z[len(y), len(x)]`` at ``levels`` (an int: the
        automatic levels; else the values); the grid's corners are sticky
        and the view is autoscaled tight at once."""
        x = np.asarray(x, np.float64)
        y = np.asarray(y, np.float64)
        z = np.asarray(z, np.float64)
        if z.shape != (len(y), len(x)):
            raise TypeError(f"contour: z has shape {z.shape}, x and y "
                            f"give ({len(y)}, {len(x)})")
        zmin, zmax = float(z.min()), float(z.max())
        if isinstance(levels, (int, np.integer)):
            lev = contour_levels(zmin, zmax, int(levels))
        else:
            lev = np.asarray(levels, np.float64)
        norm = Normalize(float(lev.min()), float(lev.max()))
        colors = [tuple(c) for c in get_cmap(cmap)(norm(lev))] \
            if len(lev) > 1 else [get_cmap(cmap)(0.0)]
        cs = ContourSet(lev, [marching_squares(x, y, z, v) for v in lev],
                        colors)
        self._add(cs)
        mins, maxs = (float(x.min()), float(y.min())), (float(x.max()),
                                                        float(y.max()))
        cs.sticky_x, cs.sticky_y = [mins[0], maxs[0]], [mins[1], maxs[1]]
        self._update_datalim([mins, maxs])
        self.autoscale_view(tight=True)
        return cs

    def clabel(self, cs: ContourSet, inline=True, fontsize=None):
        """Label every level of ``cs`` with matplotlib's level text."""
        cs.label_texts = level_texts(cs.levels)
        cs.label_fontsize = fontsize
        return cs.label_texts

    def twinx(self) -> "Axes":
        """A second axes over this one with its own y axis on the right and
        this one's x axis."""
        twin = Axes(self.figure, self.rect, sharex=self)
        twin.y_right, twin.x_visible, twin.frame_on = True, False, False
        self.figure.axes.append(twin)
        return twin

    # -- labels and ticks -------------------------------------------------
    def set_xlabel(self, text):
        self.xlabel = str(text)

    def set_ylabel(self, text, color=None):
        self.ylabel = str(text)
        if color is not None:
            self.ylabel_color = to_rgba(color)

    def set_title(self, text):
        self.title = str(text)

    def set_xticks(self, ticks):
        """Fixed ticks; the view widens to hold them (matplotlib's
        ``set_view_interval``)."""
        ticks = np.asarray(list(ticks), np.float64)
        self.xticks = ticks
        self._shared["x"].locator = "fixed"
        if len(ticks):
            lo, hi = self.get_xlim()
            group = self._shared["x"]
            t0, t1 = float(ticks.min()), float(ticks.max())
            group.view = [min(t0, t1, lo), max(t0, t1, hi)] if lo < hi \
                else [max(t0, t1, lo), min(t0, t1, hi)]
            group.mutated = True

    def set_xticklabels(self, labels, rotation=0, fontsize=None):
        self.xticklabels = [str(s) for s in labels]
        self.xticklabel_rotation = float(rotation)
        self.xticklabel_fontsize = fontsize

    def legend(self, frameon=True, fontsize=None) -> Legend:
        """The labelled artists, then the labelled ``bar`` containers."""
        entries = [(a, a.label) for a in self.children if a.in_legend]
        entries += [(c, c.label) for c in self.containers if c.in_legend]
        self.legend_ = Legend(entries, frameon, fontsize)
        return self.legend_

    def get_legend(self) -> Optional[Legend]:
        return self.legend_


class Axes3D:
    """A 3-D axes that holds ``plot_surface``; drawn at matplotlib's
    default view (elevation 30, azimuth -60), back to front."""
    name = "3d"
    elev, azim = 30.0, -60.0

    def __init__(self, figure: "Figure", rect):
        self.figure, self.rect = figure, list(rect)
        self.children: List[Artist] = []
        self.xlabel = self.ylabel = self.title = ""
        self.legend_ = None

    @property
    def collections(self) -> List[Artist]:
        return list(self.children)

    def plot_surface(self, X, Y, Z, cmap="viridis", linewidth=0):
        """The grid sampled at strides ``ceil(rows / 50)``,
        ``ceil(cols / 50)`` (the last row and column kept); one perimeter
        polygon per sampled cell, coloured by its mean z."""
        X, Y, Z = (np.asarray(a, np.float64) for a in (X, Y, Z))
        rows, cols = Z.shape
        rstride = int(max(np.ceil(rows / SURFACE_COUNT), 1))
        cstride = int(max(np.ceil(cols / SURFACE_COUNT), 1))
        row_inds = list(range(0, rows - 1, rstride)) + [rows - 1]
        col_inds = list(range(0, cols - 1, cstride)) + [cols - 1]
        polys = []
        for rs, rn in zip(row_inds[:-1], row_inds[1:]):
            for cs, cn in zip(col_inds[:-1], col_inds[1:]):
                ps = [_perimeter(a[rs:rn + 1, cs:cn + 1]) for a in (X, Y, Z)]
                polys.append(np.stack(ps, axis=1))
        avg = np.array([p[:, 2].mean() for p in polys]) if polys else \
            np.zeros(0)
        norm = Normalize()
        colors = get_cmap(cmap)(norm(avg)) if len(avg) else np.zeros((0, 4))
        surf = Surface(polys, colors, rstride, cstride, row_inds, col_inds)
        self.children.append(surf)
        return surf


def _perimeter(a: np.ndarray) -> np.ndarray:
    """The boundary of a 2-D block, counter-clockwise from [0, 0]
    (matplotlib ``cbook._array_perimeter``)."""
    forward, backward = np.s_[0:-1], np.s_[:0:-1]
    return np.concatenate((a[0, forward], a[forward, -1],
                           a[-1, backward], a[backward, 0]))


# -- figures -------------------------------------------------------------

class Figure:
    """A page of ``figsize`` inches holding its axes in creation order
    (twins after their host, a colorbar's axes after its host)."""

    def __init__(self, figsize=(6.4, 4.8)):
        self.figsize = (float(figsize[0]), float(figsize[1]))
        self.axes: List = []
        self._grid = None

    def add_subplot(self, nrows=1, ncols=1, index=1, projection=None):
        """The ``index``-th (from 1) cell of an ``nrows`` x ``ncols``
        grid."""
        rect = _cell(self.figsize, nrows, ncols, index)
        ax = Axes3D(self, rect) if projection == "3d" else Axes(self, rect)
        self.axes.append(ax)
        return ax

    def colorbar(self, mappable: PathCollection, label="") -> Colorbar:
        """A bar beside the axes that holds ``mappable``, taking 15% of its
        width (matplotlib's ``fraction``)."""
        host = next(a for a in self.axes
                    if isinstance(a, Axes) and mappable in a.children)
        x0, y0, w, h = host.rect
        host.rect[2] = w * (1 - 0.15 - 0.05)
        cax = Axes(self, [x0 + w * 0.85 + w * 0.02, y0 + h * 0.1,
                          w * 0.04, h * 0.8])
        cax.y_right, cax.x_visible = True, False
        self.axes.append(cax)
        return Colorbar(mappable, cax, label)

    def savefig(self, path: str, dpi=100.0, format=None, **_):
        """Write this figure to ``path`` in the format its suffix (or
        ``format``) names: ``pdf``, ``svg`` or ``png``, one layout for the
        three (:func:`render`). ``dpi`` sets the PNG's pixels per inch
        (matplotlib's default figure dpi, 100, where none is given); the
        vector formats are in points. Another format raises
        ``ValueError``; ``bbox_inches`` changes nothing (the page is the
        figure's size)."""
        from curvature_tpu_torch.utils import pdf, png, svg
        kind = (format or os.path.splitext(path)[1].lstrip(".")).lower()
        if kind not in SAVE_FORMATS:
            raise ValueError(
                f"{path}: the format {kind or '(none)'!r} is not one the "
                f"port writes; it writes {', '.join(SAVE_FORMATS)}")
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        w, h = self.figsize[0] * 72.0, self.figsize[1] * 72.0
        if kind == "pdf":
            canvas = pdf.Canvas(w, h)
            render(self, canvas)
            pdf.write_pdf(path, [canvas])
        elif kind == "svg":
            canvas = svg.Canvas(w, h)
            render(self, canvas)
            svg.write_svg(path, canvas)
        else:
            canvas = png.Canvas(w, h, dpi=float(dpi))
            render(self, canvas)
            png.write_png(path, canvas)


#: the formats :meth:`Figure.savefig` writes
SAVE_FORMATS = ("pdf", "svg", "png")


def _cell(figsize, nrows, ncols, index):
    """A grid cell in figure fractions, inside fixed point margins (left
    62, right 56, bottom 48, top 30; 64 between columns, 48 between
    rows)."""
    W, H = figsize[0] * 72.0, figsize[1] * 72.0
    left, right, bottom, top, wgap, hgap = 62.0, 56.0, 48.0, 30.0, 64.0, 48.0
    cw = (W - left - right - wgap * (ncols - 1)) / ncols
    ch = (H - bottom - top - hgap * (nrows - 1)) / nrows
    r, c = divmod(index - 1, ncols)
    x = left + c * (cw + wgap)
    y = H - top - (r + 1) * ch - r * hgap
    return [x / W, y / H, cw / W, ch / H]


def figure(figsize=(6.4, 4.8), tight_layout=False) -> Figure:
    return Figure(figsize)


def subplots(nrows=1, ncols=1, figsize=(6.4, 4.8), tight_layout=False):
    """(figure, axes): one :class:`Axes`, or a list of them for a grid."""
    fig = Figure(figsize)
    axes = [fig.add_subplot(nrows, ncols, i + 1)
            for i in range(nrows * ncols)]
    return fig, axes[0] if len(axes) == 1 else axes


# -- drawing -------------------------------------------------------------

def text_width(text: str, size: float) -> float:
    """The advance of ``text`` in Helvetica at ``size`` points."""
    return sum(HELVETICA_WIDTHS[ord(ch) - 32] if 32 <= ord(ch) <= 126
               else 556 for ch in text) * size / 1000.0


_DASHES = {"-": None, "--": (3.7, 1.6), ":": (1.0, 1.65),
           "-.": (6.4, 1.6, 1.0, 1.6)}


class _Frame:
    """Data to page coordinates for one 2-D axes."""

    def __init__(self, ax: Axes, W: float, H: float):
        x, y, w, h = ax.rect
        self.x0, self.y0, self.w, self.h = x * W, y * H, w * W, h * H
        self.xlim, self.ylim = ax.get_xlim(), ax.get_ylim()
        self.xlog = ax.get_xscale() == "log"
        self.ylog = ax.get_yscale() == "log"

    @staticmethod
    def _t(v, lim, log):
        v = np.asarray(v, np.float64)
        if log:
            with np.errstate(divide="ignore", invalid="ignore"):
                v = np.log10(np.where(v > 0, v, np.nan))
            lim = (math.log10(lim[0]), math.log10(lim[1]))
        span = (lim[1] - lim[0]) or 1.0
        return (v - lim[0]) / span

    def px(self, x):
        return self.x0 + self._t(x, self.xlim, self.xlog) * self.w

    def py(self, y):
        return self.y0 + self._t(y, self.ylim, self.ylog) * self.h


def render(fig: Figure, c) -> None:
    """Draw ``fig`` on a canvas (``utils/pdf``, ``utils/svg`` or
    ``utils/png``'s ``Canvas``: one drawing interface)."""
    W, H = c.width, c.height
    c.rect(0, 0, W, H, fill=(1.0, 1.0, 1.0, 1.0))
    for ax in fig.axes:
        if isinstance(ax, Axes3D):
            _render_3d(ax, c, W, H)
        elif ax.colorbar is not None:
            _render_colorbar(ax, c, W, H)
        else:
            _render_axes(ax, c, W, H)


def _polyline(c, xs, ys, color, alpha, lw, style):
    pts = np.stack([xs, ys], axis=1)
    ok = np.isfinite(pts).all(axis=1)
    # split at non-finite points, as matplotlib breaks a path at NaN
    runs, start = [], None
    for i, good in enumerate(ok):
        if good and start is None:
            start = i
        if not good and start is not None:
            runs.append(pts[start:i])
            start = None
    if start is not None:
        runs.append(pts[start:])
    dash = _DASHES.get(style)
    for run in runs:
        if len(run) > 1 and style not in ("None", "", " "):
            c.path(run, stroke=color, alpha=alpha, width=lw,
                   dash=None if dash is None else [d * lw for d in dash])


def _marker(c, x, y, marker, size, face, edge, alpha):
    r = size / 2.0
    if marker == "o":
        c.circle(x, y, r, fill=face, stroke=edge, alpha=alpha, width=0.8)
    elif marker == "s":
        c.rect(x - r, y - r, 2 * r, 2 * r, fill=face, stroke=edge,
               alpha=alpha, width=0.8)
    elif marker == "*":
        angles = np.pi / 2 + np.arange(10) * np.pi / 5
        radii = np.where(np.arange(10) % 2 == 0, r, r * 0.381966)
        pts = np.stack([x + radii * np.cos(angles),
                        y + radii * np.sin(angles)], axis=1)
        c.path(pts, close=True, fill=face, stroke=edge, alpha=alpha,
               width=0.8)


def _render_axes(ax: Axes, c, W, H):
    f = _Frame(ax, W, H)
    c.push_clip(f.x0, f.y0, f.w, f.h)
    for art in sorted(ax.children, key=lambda a: a.zorder):
        if isinstance(art, Rectangle):
            x0, x1 = f.px([art.x, art.x + art.width])
            y0, y1 = f.py([art.y, art.y + art.height])
            if not np.isfinite([x0, x1, y0, y1]).all():
                continue
            rx, ry = min(x0, x1), min(y0, y1)
            rw, rh = abs(x1 - x0), abs(y1 - y0)
            edge = art.edgecolor if art.edgecolor[3] > 0 else None
            face = art.facecolor if art.facecolor[3] > 0 else None
            if face is None and edge is None:
                continue
            c.rect(rx, ry, rw, rh, fill=face, stroke=edge,
                   width=art.linewidth)
            if art.hatch and edge is not None:
                c.hatch(rx, ry, rw, rh, edge, spacing=6.0 / art.hatch.count(
                    "/"))
        elif isinstance(art, Line):
            xs = f.px(art.x)
            ys = f.y0 + art.y * f.h if art.axis_y else f.py(art.y)
            _polyline(c, xs, ys, art.color, art.alpha, art.linewidth,
                      art.linestyle)
            if art.marker != "None":
                for x, y in zip(xs, ys):
                    if np.isfinite(x) and np.isfinite(y):
                        _marker(c, x, y, art.marker, art.markersize,
                                art.color, art.color, art.alpha)
        elif isinstance(art, LineCollection):
            for seg in art.segments:
                _polyline(c, f.px(seg[:, 0]), f.py(seg[:, 1]), art.color,
                          art.alpha, art.linewidth, "-")
        elif isinstance(art, PathCollection):
            faces = art.facecolors
            for (x, y), s, face in zip(art.offsets, art.sizes, faces):
                px, py = float(f.px(x)), float(f.py(y))
                if np.isfinite(px) and np.isfinite(py):
                    _marker(c, px, py, art.marker, math.sqrt(s),
                            tuple(face), tuple(face), art.alpha)
        elif isinstance(art, ContourSet):
            for segs, color, text in zip(
                    art.allsegs, art.colors,
                    art.label_texts or [None] * len(art.levels)):
                for seg in segs:
                    _polyline(c, f.px(seg[:, 0]), f.py(seg[:, 1]), color,
                              None, 1.5, "-")
                if text is not None and segs:
                    # on the level's highest segment
                    mid = max((seg.mean(axis=0) for seg in segs),
                              key=lambda p: p[1])
                    c.text(float(f.px(mid[0])), float(f.py(mid[1])),
                           text.replace("−", "-"),
                           art.label_fontsize or 10.0, color,
                           halign="center", valign="center")
    c.pop_clip()
    _render_frame(ax, f, c)


def _render_frame(ax: Axes, f: _Frame, c, size=10.0):
    black = (0.0, 0.0, 0.0, 1.0)
    if ax.frame_on:
        c.rect(f.x0, f.y0, f.w, f.h, stroke=black, width=0.8)
    # x ticks (a twin shows none)
    if ax.x_visible:
        if ax.xticks is not None:
            ticks = ax.xticks
            labels = ax.xticklabels if ax.xticklabels is not None else \
                tick_texts(ticks)
        else:
            ticks = log_ticks(*sorted(f.xlim)) if f.xlog else \
                nice_ticks(*sorted(f.xlim))
            labels = tick_texts(ticks, f.xlog)
        fs = ax.xticklabel_fontsize or size
        deepest = 0.0
        for t, s in zip(ticks, labels):
            x = float(f.px(t))
            if not (f.x0 - 0.01 <= x <= f.x0 + f.w + 0.01):
                continue
            c.path([(x, f.y0), (x, f.y0 - 3.5)], stroke=black, width=0.8)
            if ax.xticklabel_rotation:
                c.text(x, f.y0 - 6.0, s, fs, black,
                       halign="right", valign="center",
                       rotation=ax.xticklabel_rotation)
                deepest = max(deepest, text_width(s, fs))
            else:
                c.text(x, f.y0 - 6.0, s, fs, black, halign="center",
                       valign="top")
                deepest = max(deepest, fs)
        if ax.xlabel:
            c.text(f.x0 + f.w / 2, f.y0 - 10.0 - deepest, ax.xlabel, size,
                   black, halign="center", valign="top")
    # y ticks, on the left or (a twin) on the right
    ticks = log_ticks(*sorted(f.ylim)) if f.ylog else \
        nice_ticks(*sorted(f.ylim))
    labels = tick_texts(ticks, f.ylog)
    edge = f.x0 + f.w if ax.y_right else f.x0
    sign = 1.0 if ax.y_right else -1.0
    widest = 0.0
    for t, s in zip(ticks, labels):
        y = float(f.py(t))
        if not (f.y0 - 0.01 <= y <= f.y0 + f.h + 0.01):
            continue
        c.path([(edge, y), (edge + sign * 3.5, y)], stroke=black, width=0.8)
        c.text(edge + sign * 6.0, y, s, size, black,
               halign="left" if ax.y_right else "right", valign="center")
        widest = max(widest, text_width(s, size))
    if ax.ylabel:
        c.text(edge + sign * (10.0 + widest + size * 0.3), f.y0 + f.h / 2,
               ax.ylabel, size, ax.ylabel_color, halign="center",
               valign="bottom" if not ax.y_right else "top", rotation=90.0)
    if ax.title:
        c.text(f.x0 + f.w / 2, f.y0 + f.h + 6.0, ax.title, 12.0, black,
               halign="center", valign="bottom")
    if ax.legend_ is not None and ax.legend_.entries:
        _render_legend(ax.legend_, f, c)


def _render_legend(leg: Legend, f: _Frame, c):
    size = float(leg.fontsize or 10.0)
    black = (0.0, 0.0, 0.0, 1.0)
    row, swatch = size * 1.4, size * 2.0
    width = swatch + size * 0.8 + max(text_width(t, size) for t in leg.texts)
    height = row * len(leg.entries) + size * 0.4
    x0 = f.x0 + f.w - width - size * 0.8
    y1 = f.y0 + f.h - size * 0.5
    if leg.frameon:
        c.rect(x0 - size * 0.4, y1 - height, width + size * 0.8, height,
               fill=(1.0, 1.0, 1.0, 0.8), stroke=(0.8, 0.8, 0.8, 1.0),
               width=0.8)
    for k, (art, text) in enumerate(leg.entries):
        y = y1 - size * 0.2 - row * (k + 0.5)
        if isinstance(art, Line):
            _polyline(c, np.array([x0, x0 + swatch]), np.array([y, y]),
                      art.color, art.alpha, art.linewidth, art.linestyle)
            if art.marker != "None":
                _marker(c, x0 + swatch / 2, y, art.marker, art.markersize,
                        art.color, art.color, art.alpha)
        else:
            patch = art.patches[0] if isinstance(art, Container) and \
                art.patches else art
            if isinstance(patch, Rectangle):
                face = patch.facecolor if patch.facecolor[3] > 0 else None
                edge = patch.edgecolor if patch.edgecolor[3] > 0 else None
                c.rect(x0, y - size * 0.35, swatch, size * 0.7, fill=face,
                       stroke=edge, width=patch.linewidth)
                if patch.hatch and edge is not None:
                    c.hatch(x0, y - size * 0.35, swatch, size * 0.7, edge,
                            spacing=3.0)
            elif isinstance(patch, (LineCollection, PathCollection)):
                color = patch.color if isinstance(patch, LineCollection) \
                    else tuple(patch.facecolors[0])
                c.path([(x0, y), (x0 + swatch, y)], stroke=color, width=1.5)
        c.text(x0 + swatch + size * 0.8, y, text, size, black,
               halign="left", valign="center")


def _render_colorbar(ax: Axes, c, W, H):
    cb = ax.colorbar
    f = _Frame(ax, W, H)
    n = cb.mappable.cmap.N
    for k in range(n):
        color = tuple(cb.mappable.cmap.lut[k])
        c.rect(f.x0, f.y0 + f.h * k / n, f.w, f.h / n + 0.05, fill=color)
    _render_frame(ax, f, c)


def _render_3d(ax: Axes3D, c, W, H):
    x, y, w, h = ax.rect
    x0, y0, w, h = x * W, y * H, w * W, h * H
    polys = [p for s in ax.children for p in s.polys]
    faces = [fc for s in ax.children for fc in s.facecolors]
    if not polys:
        return
    allp = np.concatenate(polys)
    lo, hi = np.nanmin(allp, axis=0), np.nanmax(allp, axis=0)
    span = np.where(hi > lo, hi - lo, 1.0)
    el, az = math.radians(ax.elev), math.radians(ax.azim)
    # the unit box's coordinates: right, up and toward the viewer
    right = np.array([-math.sin(az), math.cos(az), 0.0])
    toward = np.array([math.cos(el) * math.cos(az),
                       math.cos(el) * math.sin(az), math.sin(el)])
    up = np.cross(toward, right)
    corners = np.array([[i, j, k] for i in (0, 1) for j in (0, 1)
                        for k in (0, 1)], np.float64) - 0.5
    bx, by = corners @ right, corners @ up
    scale = min(w / (bx.max() - bx.min()), h / (by.max() - by.min())) * 0.9
    cx, cy = x0 + w / 2, y0 + h / 2

    def project(p):
        u = (p - lo) / span - 0.5
        return np.stack([cx + scale * (u @ right), cy + scale * (u @ up)],
                        axis=1), u @ toward

    # the box's three back panes' edges, then the faces back to front
    grey = (0.6, 0.6, 0.6, 1.0)
    pts, _ = project(lo + (corners + 0.5) * span)
    for i in range(8):
        for j in range(i + 1, 8):
            if np.abs(corners[i] - corners[j]).sum() == 1.0:
                c.path([pts[i], pts[j]], stroke=grey, width=0.5)
    order = []
    for poly, face in zip(polys, faces):
        xy, depth = project(poly)
        order.append((float(np.mean(depth)), xy, face))
    for _, xy, face in sorted(order, key=lambda t: t[0]):
        if np.isfinite(xy).all():
            c.path(xy, close=True, fill=tuple(face))
