"""FrontISTR analysis control file (``.cnt``) reader.

Replicates the card deck grammar of the reference setup layer
(fistr1/src/common/fstr_setup.f90:131-285 pass structure; tokenizer
fistr1/src/common/fstr_ctrl_util.c).  Cards are parsed generically into
``Card`` records, then interpreted into a typed ``AnalysisConfig`` covering
!SOLUTION !SOLVER !STEP/!ISTEP !BOUNDARY !CLOAD !DLOAD !TEMPERATURE !SPRING
!REFTEMP !MATERIAL(+!ELASTIC/!PLASTIC/!HYPERELASTIC/!VISCOELASTIC/!CREEP/
!DENSITY/!EXPANSION_COEFF) !HEAT !FIXTEMP !CFLUX !DFLUX !SFLUX !FILM !SFILM
!RADIATE !SRADIATE !EIGEN !DYNAMIC !VELOCITY !ACCELERATION !CONTACT
!CONTACT_ALGO !WRITE !OUTPUT_RES !OUTPUT_VIS !RESTART !AUTOINC_PARAM
!TIME_POINTS !COUPLE !MPC !ECHO !INCLUDE !AMPLITUDE !END.
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import Dict, List, Optional

_num_re = re.compile(r"[,\s]+")


def _split(line: str) -> List[str]:
    """Tokenize a data line.  Comma-separated decks are positional: empty
    fields ("  ,,,,100") must be preserved (fstr_ctrl_util.c record
    semantics), so split on commas keeping empties when present."""
    s = line.strip()
    if "," in s:
        return [t.strip() for t in s.rstrip(",").split(",")]
    return [t for t in s.split() if t]


def _f(tok, default: float = 0.0) -> float:
    try:
        return float(tok)
    except (TypeError, ValueError):
        pass
    # Fortran double-precision literals ('7.d0', '1.5D-3') — the
    # reference's ctrl reader accepts them (fstr_ctrl_util.c strtod on
    # d/D-exponent forms via Fortran list-directed reads)
    try:
        return float(str(tok).lower().replace("d", "e"))
    except (TypeError, ValueError):
        return default


@dataclasses.dataclass
class Card:
    name: str
    params: Dict[str, str]
    data: List[List[str]]
    raw: str = ""

    def param(self, key: str, default=None):
        return self.params.get(key.upper(), default)

    def fparam(self, key: str, default: float = 0.0) -> float:
        v = self.params.get(key.upper())
        return float(v) if v is not None else default

    def iparam(self, key: str, default: int = 0) -> int:
        v = self.params.get(key.upper())
        return int(float(v)) if v is not None else default

    def has(self, key: str) -> bool:
        return key.upper() in self.params

    def rows_f(self) -> List[List[float]]:
        return [[_f(v) for v in row] for row in self.data]


@dataclasses.dataclass
class SolverConfig:
    # fstr_ctrl_get_SOLVER (fstr_ctrl_common.f90:69-169); method list :98
    method: str = "CG"
    precond: int = 1
    iterlog: bool = False
    timelog: bool = False
    nier: int = 10000
    iter_premax: int = 1
    nrest: int = 10
    resid: float = 1.0e-8
    sigma_diag: float = 1.0
    sigma: float = 0.0
    scaling: bool = False
    dumptype: str = "NONE"
    estcond: int = 0
    mpc_method: int = 0  # 0: auto


@dataclasses.dataclass
class StepInfo:
    # m_step.f90 step_info + fstr_ctrl_get_ISTEP
    solution: str = "STATIC"       # STATIC / VISCO
    inc_type: str = "FIXED"        # FIXED / AUTO
    num_substep: int = 1
    max_iter: int = 50
    max_contiter: int = 10
    converg: float = 1.0e-6
    converg_lag: float = 1.0e-4
    converg_ddisp: float = -1.0
    maxres: float = 1.0e10
    initdt: float = 1.0
    elapsetime: float = 1.0
    mindt: float = 1.0e-4
    maxdt: float = 1.0
    starttime: float = 0.0
    amp: str = ""
    timepoints: str = ""
    aincparam: str = ""
    boundary_groups: List[int] = dataclasses.field(default_factory=list)
    load_groups: List[int] = dataclasses.field(default_factory=list)
    contact_groups: List[int] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class CntMaterial:
    """Material defined in the .cnt deck (!MATERIAL + subcards)."""
    name: str
    elastic: Optional[Card] = None
    plastic: Optional[Card] = None
    hyperelastic: Optional[Card] = None
    viscoelastic: Optional[Card] = None
    trs: Optional[Card] = None
    creep: Optional[Card] = None
    density: Optional[Card] = None
    expansion: Optional[Card] = None
    user_material: Optional[Card] = None
    fluid: Optional[Card] = None


@dataclasses.dataclass
class DynamicConfig:
    # fstr_ctrl_get_DYNAMIC (fstr_ctrl_dynamic.f90); fields mirror fstr_dynamic
    idx_eqa: int = 1          # 1: implicit Newmark, 11: explicit central diff
    idx_resp: int = 1         # 1: time history, 2: frequency response
    n_step: int = 1
    t_start: float = 0.0
    t_end: float = 1.0
    t_delta: float = 1.0
    gamma: float = 0.5
    beta: float = 0.25
    idx_mas: int = 1          # 1: lumped, 2: consistent
    idx_dmp: int = 1
    ray_m: float = 0.0
    ray_k: float = 0.0
    nout: int = 100
    node_monit_1: int = 0
    nout_monit: int = 1
    iout_list: List[int] = dataclasses.field(default_factory=lambda: [0] * 6)


@dataclasses.dataclass
class EigenConfig:
    # fstr_ctrl_get_EIGEN (fstr_ctrl_eigen.f90): nget, lcztol, lczmax
    nget: int = 5
    tolerance: float = 1.0e-8
    maxiter: int = 60


@dataclasses.dataclass
class HeatConfig:
    # fstr_ctrl_get_HEAT (fstr_ctrl_heat.f90): dt, etime, dtmin, deltmx, ...
    fixed_dt: float = 0.0
    total_time: float = 0.0
    dt_min: float = 0.0
    dt_max: float = 0.0
    deltmx: float = 0.0
    itmax: int = 20
    eps: float = 1.0e-6
    timepoints: str = ""


@dataclasses.dataclass
class AnalysisConfig:
    solution_type: str = "STATIC"
    nlgeom: bool = False
    version: int = 0
    solver: SolverConfig = dataclasses.field(default_factory=SolverConfig)
    steps: List[StepInfo] = dataclasses.field(default_factory=list)
    boundaries: List[Card] = dataclasses.field(default_factory=list)
    cloads: List[Card] = dataclasses.field(default_factory=list)
    dloads: List[Card] = dataclasses.field(default_factory=list)
    temperatures: List[Card] = dataclasses.field(default_factory=list)
    springs: List[Card] = dataclasses.field(default_factory=list)
    materials: Dict[str, CntMaterial] = dataclasses.field(default_factory=dict)
    sections: List[Card] = dataclasses.field(default_factory=list)
    orientations: List[Card] = dataclasses.field(default_factory=list)
    reftemp: float = 0.0
    write_result: bool = False
    write_visual: bool = False
    # '!WRITE,RESULT,FREQUENCY=n' / '!WRITE,VISUAL,FREQUENCY=n': emit a
    # result file / render every n (time-)steps in transient analyses
    # (fstr_setup.f90 fstr_setup_WRITE; heat_solve_TRAN.f90:268-270
    # calls both per interval)
    result_frequency: int = 1
    visual_frequency: int = 1
    visual: dict = dataclasses.field(default_factory=dict)
    write_log: bool = True
    output_res: List[Card] = dataclasses.field(default_factory=list)
    output_vis: List[Card] = dataclasses.field(default_factory=list)
    restart: Optional[Card] = None
    # heat
    heat: Optional[HeatConfig] = None
    fixtemps: List[Card] = dataclasses.field(default_factory=list)
    cfluxes: List[Card] = dataclasses.field(default_factory=list)
    dfluxes: List[Card] = dataclasses.field(default_factory=list)
    sfluxes: List[Card] = dataclasses.field(default_factory=list)
    films: List[Card] = dataclasses.field(default_factory=list)
    sfilms: List[Card] = dataclasses.field(default_factory=list)
    radiates: List[Card] = dataclasses.field(default_factory=list)
    sradiates: List[Card] = dataclasses.field(default_factory=list)
    weldlines: List[Card] = dataclasses.field(default_factory=list)
    # dynamic / eigen
    dynamic: Optional[DynamicConfig] = None
    eigen: Optional[EigenConfig] = None
    velocities: List[Card] = dataclasses.field(default_factory=list)
    accelerations: List[Card] = dataclasses.field(default_factory=list)
    floads: List[Card] = dataclasses.field(default_factory=list)
    eigenread: Optional[Card] = None
    # contact
    contact_algo: str = "SLAGRANGE"
    contacts: List[Card] = dataclasses.field(default_factory=list)
    embeds: List[Card] = dataclasses.field(default_factory=list)
    # misc
    echo: bool = False
    mpc_penalty: float = 1.0e10
    autoinc_params: List[Card] = dataclasses.field(default_factory=list)
    time_points: List[Card] = dataclasses.field(default_factory=list)
    amplitudes: List[Card] = dataclasses.field(default_factory=list)
    couple: Optional[Card] = None
    elemopt361: int = 0
    all_cards: List[Card] = dataclasses.field(default_factory=list)


def _parse_header_line(line: str):
    body = line.strip()[1:]
    parts = [p.strip() for p in body.split(",")]
    name = parts[0].upper().replace(" ", "_")
    params: Dict[str, str] = {}
    for p in parts[1:]:
        if "=" in p:
            k, v = p.split("=", 1)
            params[k.strip().upper()] = v.strip()
        elif p:
            params[p.strip().upper()] = "1"
    return name, params


def parse_cards(path: str) -> List[Card]:
    with open(path, errors="replace") as f:
        lines = f.readlines()
    cards: List[Card] = []
    cur: Optional[Card] = None
    base = os.path.dirname(os.path.abspath(path))
    i = 0
    while i < len(lines):
        s = lines[i].strip()
        i += 1
        if not s or s.startswith("#") or s.startswith("!!"):
            continue
        if s.startswith("!"):
            name, params = _parse_header_line(s)
            if name == "END":
                break
            if name == "INCLUDE":
                inc = params.get("INPUT") or (s.split("=", 1)[1].strip()
                                              if "=" in s else "")
                if inc:
                    cards.extend(parse_cards(os.path.join(base, inc)))
                continue
            cur = Card(name, params, [], raw=s)
            cards.append(cur)
            continue
        if cur is not None:
            cur.data.append(_split(s))
    return cards


_SOLVER_METHODS = {"CG", "BICGSTAB", "GMRES", "GPBICG", "GMRESR", "GMRESREN",
                   "DIRECT", "DIRECTMKL", "DIRECTLAG", "MUMPS", "MKL"}


def read_cnt(path: str) -> AnalysisConfig:
    cards = parse_cards(path)
    cfg = AnalysisConfig(all_cards=cards)
    cur_mat: Optional[CntMaterial] = None
    in_visual = False

    for c in cards:
        n = c.name
        if n == "VERSION":
            if c.data:
                cfg.version = int(float(c.data[0][0]))
        elif n == "SOLUTION":
            t = (c.param("TYPE") or "STATIC").upper()
            cfg.solution_type = t
            cfg.nlgeom = t in ("NLSTATIC", "STATICEIGEN") or cfg.nlgeom
            if t == "NLSTATIC":
                cfg.solution_type = "NLSTATIC"
        elif n == "NONLINEAR_SOLVER":
            pass
        elif n == "STATIC":
            # v1-format "!STATIC, TYPE=NLGEOM" (fstr_ctrl_static.f90)
            if (c.param("TYPE") or "").upper() == "NLGEOM":
                cfg.nlgeom = True
                cfg.solution_type = "NLSTATIC"
        elif n == "SOLVER":
            sv = cfg.solver
            sv.method = (c.param("METHOD") or "CG").upper()
            sv.precond = c.iparam("PRECOND", 1)
            sv.iterlog = (c.param("ITERLOG", "NO").upper() == "YES")
            sv.timelog = (c.param("TIMELOG", "NO").upper() in ("YES", "VERBOSE"))
            sv.scaling = (c.param("SCALING", "NO").upper() == "YES")
            sv.estcond = c.iparam("ESTCOND", 0)
            if c.data:
                row = c.data[0]
                sv.nier = int(_f(row[0], 10000))
                if len(row) > 1:
                    sv.iter_premax = int(_f(row[1], 1))
                if len(row) > 2:
                    sv.nrest = int(_f(row[2], 10))
            if len(c.data) > 1:
                row = c.data[1]
                sv.resid = _f(row[0], 1.0e-8)
                if len(row) > 1:
                    sv.sigma_diag = _f(row[1], 1.0)
                if len(row) > 2:
                    sv.sigma = _f(row[2])
        elif n in ("STEP", "ISTEP"):
            st = StepInfo()
            st.solution = (c.param("TYPE") or "STATIC").upper()
            st.inc_type = (c.param("INC_TYPE") or "FIXED").upper()
            st.num_substep = c.iparam("SUBSTEPS", 1)
            st.initdt = 1.0 / st.num_substep
            st.max_iter = c.iparam("ITMAX", c.iparam("MAXITER", 50))
            st.max_contiter = c.iparam("MAXCONTITER", 10)
            st.converg = c.fparam("CONVERG", 1.0e-6)
            st.maxres = c.fparam("MAXRES", 1.0e10)
            st.amp = c.param("AMP", "")
            st.timepoints = c.param("TIMEPOINTS", "")
            st.aincparam = c.param("AUTOINCPARAM", "")
            rows = c.data
            start = 0
            if rows:
                try:
                    fn = float(rows[0][0])
                    st.initdt = fn
                    if len(rows[0]) > 1:
                        st.elapsetime = float(rows[0][1])
                    if len(rows[0]) > 2:
                        st.mindt = min(float(rows[0][2]), st.initdt)
                    if len(rows[0]) > 3:
                        st.maxdt = float(rows[0][3])
                    st.num_substep = max(
                        int((st.elapsetime + 0.999999999 * fn) / fn),
                        st.num_substep)
                    start = 1
                except ValueError:
                    pass
            for row in rows[start:]:
                kind = row[0].upper()
                gid = int(float(row[1])) if len(row) > 1 else 1
                if kind == "BOUNDARY":
                    st.boundary_groups.append(gid)
                elif kind == "LOAD":
                    st.load_groups.append(gid)
                elif kind == "CONTACT":
                    st.contact_groups.append(gid)
            cfg.steps.append(st)
        elif n == "BOUNDARY":
            cfg.boundaries.append(c)
        elif n == "CLOAD":
            cfg.cloads.append(c)
        elif n == "DLOAD":
            cfg.dloads.append(c)
        elif n == "TEMPERATURE":
            cfg.temperatures.append(c)
        elif n == "SPRING":
            cfg.springs.append(c)
        elif n == "REFTEMP":
            if c.data:
                cfg.reftemp = float(c.data[0][0])
        elif n == "MATERIAL":
            name = c.param("NAME", f"MAT{len(cfg.materials)+1}")
            cur_mat = CntMaterial(name)
            cfg.materials[name] = cur_mat
        elif n in ("ELASTIC", "PLASTIC", "HYPERELASTIC", "VISCOELASTIC",
                   "TRS", "CREEP", "DENSITY", "EXPANSION_COEFF",
                   "EXPANSION", "USER_MATERIAL",
                   "FLUID") and cur_mat is None:
            # header-less property cards (tutorial/13: !DENSITY +
            # !HYPERELASTIC with no !MATERIAL): the reference attaches
            # them to the mesh-defined material — collect under the
            # anonymous name, bound at model build (_resolve_material)
            cur_mat = CntMaterial("")
            cfg.materials[""] = cur_mat
            continue_card = c
            n2 = n
            # fall through by re-dispatching the same card
            if n2 == "ELASTIC":
                cur_mat.elastic = continue_card
            elif n2 == "PLASTIC":
                cur_mat.plastic = continue_card
            elif n2 == "HYPERELASTIC":
                cur_mat.hyperelastic = continue_card
            elif n2 == "VISCOELASTIC":
                cur_mat.viscoelastic = continue_card
            elif n2 == "TRS":
                cur_mat.trs = continue_card
            elif n2 == "CREEP":
                cur_mat.creep = continue_card
            elif n2 == "DENSITY":
                cur_mat.density = continue_card
            elif n2 in ("EXPANSION_COEFF", "EXPANSION"):
                cur_mat.expansion = continue_card
            elif n2 == "USER_MATERIAL":
                cur_mat.user_material = continue_card
            elif n2 == "FLUID":
                cur_mat.fluid = continue_card
        elif n == "ELASTIC" and cur_mat:
            cur_mat.elastic = c
        elif n == "PLASTIC" and cur_mat:
            cur_mat.plastic = c
        elif n == "HYPERELASTIC" and cur_mat:
            cur_mat.hyperelastic = c
        elif n == "VISCOELASTIC" and cur_mat:
            cur_mat.viscoelastic = c
        elif n == "TRS" and cur_mat:
            cur_mat.trs = c
        elif n == "CREEP" and cur_mat:
            cur_mat.creep = c
        elif n == "DENSITY" and cur_mat:
            cur_mat.density = c
        elif n in ("EXPANSION_COEFF", "EXPANSION") and cur_mat:
            cur_mat.expansion = c
        elif n == "USER_MATERIAL" and cur_mat:
            cur_mat.user_material = c
        elif n == "FLUID" and cur_mat:
            cur_mat.fluid = c
        elif n == "SECTION":
            cfg.sections.append(c)
        elif n == "ORIENTATION":
            cfg.orientations.append(c)
        elif n == "VISUAL":
            cfg.visual["method"] = (c.param("METHOD") or "PSR").upper()
            in_visual = True
        elif in_visual and "=" in c.raw.split(",")[0]:
            # visualizer sub-directives: "!key = value"
            # (hecmw_vis_read_control.c grammar).  Only lines whose FIRST
            # field carries the '=' qualify — '!DYNAMIC, TYPE=…'-style
            # cards that follow a !VISUAL block must fall through to
            # their own handlers.
            k, _, v = c.raw.lstrip("!").partition("=")
            cfg.visual[k.strip().lower()] = v.strip()
        elif n == "WRITE":
            freq = max(c.iparam("FREQUENCY", 1), 1)
            if c.has("RESULT"):
                cfg.write_result = True
                cfg.result_frequency = freq
            if c.has("VISUAL"):
                cfg.write_visual = True
                cfg.visual_frequency = freq
            if c.has("LOG"):
                cfg.write_log = True
        elif n == "OUTPUT_RES":
            cfg.output_res.append(c)
        elif n == "OUTPUT_VIS":
            cfg.output_vis.append(c)
        elif n == "RESTART":
            cfg.restart = c
        elif n == "HEAT":
            # data fields: DT, ETIME, DTMIN, DELTMX, ITMAX, EPS
            # (fstr_ctrl_get_HEAT 'rrrrir', fstr_ctrl_heat.f90)
            h = HeatConfig()
            if c.data:
                row = c.data[0]
                if len(row) > 0:
                    h.fixed_dt = _f(row[0])
                if len(row) > 1:
                    h.total_time = _f(row[1])
                if len(row) > 2:
                    h.dt_min = _f(row[2])
                if len(row) > 3:
                    h.deltmx = _f(row[3])
                if len(row) > 4:
                    h.itmax = int(_f(row[4], 20.0))
                if len(row) > 5:
                    h.eps = _f(row[5], 1.0e-6)
            h.timepoints = c.param("TIMEPOINTS", "")
            cfg.heat = h
        elif n == "FIXTEMP":
            cfg.fixtemps.append(c)
        elif n == "CFLUX":
            cfg.cfluxes.append(c)
        elif n == "DFLUX":
            cfg.dfluxes.append(c)
        elif n == "SFLUX":
            cfg.sfluxes.append(c)
        elif n == "FILM":
            cfg.films.append(c)
        elif n == "SFILM":
            cfg.sfilms.append(c)
        elif n == "RADIATE":
            cfg.radiates.append(c)
        elif n == "SRADIATE":
            cfg.sradiates.append(c)
        elif n == "WELD_LINE":
            cfg.weldlines.append(c)
        elif n == "EIGEN":
            e = EigenConfig()
            if c.data:
                row = c.data[0]
                e.nget = int(float(row[0]))
                if len(row) > 1:
                    e.tolerance = float(row[1])
                if len(row) > 2:
                    e.maxiter = int(float(row[2]))
            cfg.eigen = e
        elif n == "DYNAMIC":
            d = DynamicConfig()
            # '!DYNAMIC, TYPE=NONLINEAR' switches the run to finite
            # strain (fstr_ctrl_dynamic.f90:131-134: nlgeom=(nlflag==2))
            if (c.param("TYPE") or "").upper() == "NONLINEAR":
                cfg.nlgeom = True
            rows = c.data
            if rows:
                r = [float(v) for v in rows[0]]
                d.idx_eqa = int(r[0])
                if len(r) > 1:
                    d.idx_resp = int(r[1])
            if len(rows) > 1:
                # 'rrir': t_start, t_end, n_step, t_delta
                # (fstr_ctrl_get_DYNAMIC, fstr_ctrl_dynamic.f90:53)
                r = [_f(v) for v in rows[1]]
                if len(r) > 0:
                    d.t_start = r[0]
                if len(r) > 1:
                    d.t_end = r[1]
                if len(r) > 2:
                    d.n_step = int(r[2])
                if len(r) > 3:
                    d.t_delta = r[3]
            if len(rows) > 2:
                r = [float(v) for v in rows[2]]
                if len(r) > 0:
                    d.gamma = r[0]
                if len(r) > 1:
                    d.beta = r[1]
            if len(rows) > 3:
                r = [float(v) for v in rows[3]]
                if len(r) > 0:
                    d.idx_mas = int(r[0])
                if len(r) > 1:
                    d.idx_dmp = int(r[1])
                if len(r) > 2:
                    d.ray_m = r[2]
                if len(r) > 3:
                    d.ray_k = r[3]
            if len(rows) > 4:
                r = [float(v) for v in rows[4]]
                if r:
                    d.nout = int(r[0])
                if len(r) > 1:
                    d.node_monit_1 = int(r[1])
                if len(r) > 2:
                    d.nout_monit = int(r[2])
            if len(rows) > 5:
                d.iout_list = [int(float(v)) for v in rows[5]]
            cfg.dynamic = d
        elif n == "VELOCITY":
            cfg.velocities.append(c)
        elif n == "ACCELERATION":
            cfg.accelerations.append(c)
        elif n == "FLOAD":
            cfg.floads.append(c)
        elif n == "EIGENREAD":
            # frequency-response eigen import (fstr_frequency_analysis
            # eigenlog_filename + mode range); modes are recomputed
            # in-process by the freq driver, the card is kept for the
            # mode-range selection
            cfg.eigenread = c
        elif n == "CONTACT_ALGO":
            cfg.contact_algo = (c.param("TYPE") or "SLAGRANGE").upper()
        elif n == "CONTACT":
            cfg.contacts.append(c)
        elif n == "EMBED":
            cfg.embeds.append(c)
        elif n == "MPC":
            if c.data:
                cfg.mpc_penalty = float(c.data[0][0])
        elif n == "AUTOINC_PARAM":
            cfg.autoinc_params.append(c)
        elif n == "TIME_POINTS":
            cfg.time_points.append(c)
        elif n == "AMPLITUDE":
            cfg.amplitudes.append(c)
        elif n == "COUPLE":
            cfg.couple = c
        elif n == "ELEMOPT":
            cfg.elemopt361 = c.iparam("361", 0)
        elif n == "ECHO":
            # IECHO=1: dump the consumed mesh + deck into the log
            # (static_echo.f90, heat_echo.f90)
            cfg.echo = True

    if not cfg.steps:
        cfg.steps.append(StepInfo())
    return cfg
